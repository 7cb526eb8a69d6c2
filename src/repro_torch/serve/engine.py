"""Batched serving engine with Victima-paged KV; port of
``repro.serve.engine``.

Continuous-batching style: a fixed pool of request slots; arriving
requests prefill into paged KV (pages allocated from the pool), decode
proceeds in lock-step over active slots, finished slots are shot down
(``translation_cache.invalidate_request`` + ``block_table.unmap_request``)
and refilled.  Translation of logical→physical KV pages goes through the
VTC (TC hit / cluster hit / radix walk) — the serving-side embodiment of
the paper; hit-rate stats come back with every batch.  As in the
reference the engine translates and returns physical page ids; no model
or attention kernel is attached to it.

The state is lane-batched: every leaf leads with ``[lanes]``, one
independent engine a lane (the load harness runs several), and every
function updates it IN PLACE and returns it.  The reference's masked
fixed-length scans (``admit``'s ``capacity`` iterations, per-slot merges
of the whole state) become operations on just the entries that change;
the state after each call equals the reference's leaf by leaf.  A few
small host reads (which slots to admit, retire or translate) stand in
for the masks.

Correctness invariants the serving load harness leans on:

  * **No aliasing under exhaustion.**  ``admit`` and the decode-tick
    ``grow`` only take a page when one is actually free; an exhausted
    pool rejects the admission / defers the growth instead of
    double-mapping page 0.
  * **Dead slots are invisible.**  Only live, un-stalled slots enter the
    per-tick translation batch (``translate_batch(..., valid=...)``).
  * **Pressure is a sampled window.**  ``EngineState`` carries a
    per-epoch walk/total window and latches ``pressure`` at each epoch
    boundary, so pressure decays when the working set shrinks.

The ``scope`` parameters on the host-side telemetry entry points
(``retire``, ``decode_step``, ``stats``) suffix registry metric names
with ``[scope]`` so several engines in one process do not share
counters.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

import repro_torch.obs as obs
from repro_torch.paged import block_table as btab
from repro_torch.paged import translation_cache as vtc_mod


def scoped(name: str, scope: str | None) -> str:
    """Registry metric name for one engine instance: ``name[scope]``."""
    return f"{name}[{scope}]" if scope else name


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 8                 # concurrent requests
    max_blocks_per_req: int = 64     # × TOKENS_PER_PAGE tokens
    n_pool_pages: int = 512
    n_leaf_rows: int = 64
    tc_sets: int = 16
    tc_ways: int = 4
    n_clusters: int = 64
    pressure_thresh: float = 0.3     # windowed walk rate → "pressure"
    pressure_epoch: int = 64         # ticks per pressure sampling window
    # PTW-CP cluster-install gate (freq_min, cost_min) — lower bounds
    # only (see translation_cache.translate); tuned from the simulator's
    # PTW-CP sweep by serve.load.tune_gate
    gate_freq_min: int = 1
    gate_cost_min: int = 1

    def __post_init__(self):
        # surface the VTC's power-of-two indexing requirement at config
        # construction (vtc_mod.make re-checks)
        if not vtc_mod._pow2(self.tc_sets):
            raise ValueError(
                f"EngineConfig.tc_sets must be a power of two, "
                f"got {self.tc_sets}")
        if not vtc_mod._pow2(self.n_clusters):
            raise ValueError(
                f"EngineConfig.n_clusters must be a power of two, "
                f"got {self.n_clusters}")
        if self.pressure_epoch < 1:
            raise ValueError(
                f"EngineConfig.pressure_epoch must be >= 1, "
                f"got {self.pressure_epoch}")
        if self.gate_freq_min < 0 or self.gate_cost_min < 0:
            raise ValueError(
                f"EngineConfig gate thresholds must be >= 0, got "
                f"({self.gate_freq_min}, {self.gate_cost_min})")


class EngineState(NamedTuple):
    bt: btab.BlockTables
    vtc: vtc_mod.VTC
    page_free: torch.Tensor     # int32 [L, n_pool_pages] 1=free
    slot_len: torch.Tensor      # int32 [L, n_slots] tokens decoded
    slot_live: torch.Tensor     # bool  [L, n_slots]
    tick: torch.Tensor          # int32 [L] decode ticks since init
    win_walk: torch.Tensor      # int32 [L] walks in the pressure epoch
    win_total: torch.Tensor     # int32 [L] translations in the epoch
    pressure: torch.Tensor      # bool  [L] latched at the epoch boundary
    n_pool_stall: torch.Tensor  # int32 [L] pool-exhausted events


def init(cfg: EngineConfig, lanes: int = 1, device=None) -> EngineState:
    """`lanes` empty engines on `device` (default: the card)."""
    bt = btab.make(cfg.n_slots, cfg.max_blocks_per_req, cfg.n_leaf_rows,
                   lanes, device)
    dev = bt.directory.device

    def full(shape, v, dtype=torch.int32):
        return torch.full((lanes,) + shape, v, dtype=dtype, device=dev)

    return EngineState(
        bt=bt,
        vtc=vtc_mod.make(cfg.tc_sets, cfg.tc_ways, cfg.n_clusters, lanes,
                         dev),
        page_free=full((cfg.n_pool_pages,), 1),
        slot_len=full((cfg.n_slots,), 0),
        slot_live=full((cfg.n_slots,), False, torch.bool),
        tick=full((), 0), win_walk=full((), 0), win_total=full((), 0),
        pressure=full((), False, torch.bool),
        n_pool_stall=full((), 0),
    )


def clone(st: EngineState) -> EngineState:
    """A deep copy of the state (the engine's functions work in place)."""
    return EngineState(*[type(x)(*[y.clone() for y in x])
                         if isinstance(x, tuple) else x.clone()
                         for x in st])


def _kth_free(free: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Index of the k-th (0-based) set entry of each lane's 0/1 vector
    ``free`` [L, P], for every k in ``k`` [L, m] — ``free.shape[1]``
    where a lane has no k-th: what successive ``argmax`` picks, each
    clearing its pick, would return."""
    csum = free.cumsum(1, dtype=torch.int32)
    return torch.searchsorted(csum, (k + 1).to(torch.int32).contiguous())


def _take_lowest(free: torch.Tensor, counts: torch.Tensor) -> None:
    """Clear the ``counts[l]`` lowest set entries of each lane, in place."""
    csum = free.cumsum(1, dtype=torch.int32)
    free.masked_fill_((free == 1) & (csum <= counts[:, None]), 0)


def admit(st: EngineState, slot, prompt_blocks):
    """Admit a request into `slot` of each lane: allocate + map its
    prompt pages (`slot` and `prompt_blocks` ints or ``[L]`` tensors).

    Returns ``(state, ok [L])``.  The admission is ATOMIC against pool
    exhaustion: when fewer than ``prompt_blocks`` pages are free (or the
    slot is already live, or the request is empty/oversized) NOTHING is
    allocated and ``ok`` is False — the caller re-queues the request.
    Block ``b`` maps the ``b``-th lowest free page, as the reference's
    sequence of ``argmax`` picks does; leaf rows are allocated per
    directory slot in order.
    """
    bt = st.bt
    L, _, max_dir = bt.directory.shape
    dev = bt.directory.device
    capacity = max_dir * btab.FANOUT
    lane = torch.arange(L, device=dev)
    nb = btab.lane_arg(prompt_blocks, L, dev)
    slot = btab.lane_arg(slot, L, dev).long()
    ok = ((nb > 0) & (nb <= capacity)
          & (st.page_free.sum(1, dtype=torch.int32) >= nb)
          & ~st.slot_live[lane, slot])
    # block b -> the b-th lowest free page
    bs = torch.arange(capacity, dtype=torch.int32, device=dev)
    pages = _kth_free(st.page_free, bs.expand(L, -1)).to(torch.int32)
    take = ok[:, None] & (bs[None, :] < nb[:, None])        # [L, cap]
    for d in range(max_dir):
        lo = d * btab.FANOUT
        t_d = take[:, lo:lo + btab.FANOUT]
        first = t_d[:, 0]               # the dslot's first block maps
        leaf_row = bt.directory[lane, slot, d]
        need_alloc = leaf_row < 0
        fresh = bt.leaf_free.argmax(1)
        row = torch.where(need_alloc, fresh.to(torch.int32), leaf_row)
        bt.directory[lane, slot, d] = torch.where(first, row, leaf_row)
        bt.leaf_free[lane, fresh] = torch.where(
            first & need_alloc, 0, bt.leaf_free[lane, fresh])
        r = row.long()[:, None]
        col = torch.arange(t_d.shape[1], device=dev)[None, :]
        bt.leaves[lane[:, None], r, col] = torch.where(
            t_d, pages[:, lo:lo + btab.FANOUT],
            bt.leaves[lane[:, None], r, col])
    _take_lowest(st.page_free, torch.where(ok, nb, 0))
    st.slot_len[lane, slot] = torch.where(
        ok, nb * btab.TOKENS_PER_PAGE, st.slot_len[lane, slot])
    st.slot_live[lane, slot] |= ok
    return st, ok


def admit_where(st: EngineState, prompt_blocks):
    """Batch admission: try ``prompt_blocks[l, i]`` into slot `i` of lane
    `l` (0 = no request for that slot), slot after slot, so the free-page
    guard stays atomic across slots.  Returns ``(state, oks [L,
    n_slots])``.  Slots with no request in any lane are skipped (a
    request of 0 blocks changes nothing)."""
    L, n = st.slot_len.shape
    dev = st.slot_len.device
    pb = torch.as_tensor(prompt_blocks, dtype=torch.int32).to(dev)
    oks = torch.zeros((L, n), dtype=torch.bool, device=dev)
    for i in (pb > 0).any(0).nonzero().flatten().tolist():
        st, ok = admit(st, i, pb[:, i])
        oks[:, i] = ok
    return st, oks


def _retire_one(st: EngineState, slot, where: torch.Tensor | None = None):
    """Shootdown of `slot` in each lane where `where` holds (default:
    all).  Returns (state, n_invalidated [L])."""
    bt = st.bt
    L = bt.directory.shape[0]
    dev = bt.directory.device
    lane = torch.arange(L, device=dev)
    slot = btab.lane_arg(slot, L, dev).long()
    m = torch.ones(L, dtype=torch.bool, device=dev) if where is None \
        else where
    rows = bt.directory[lane, slot]                     # [L, max_dir]
    # free the physical pages reachable from this request's leaves
    pages = bt.leaves[lane[:, None], rows.clamp_min(0).long()]
    pmask = (pages >= 0) & (rows >= 0)[:, :, None] & m[:, None, None]
    st.page_free.scatter_reduce_(
        1, pages.clamp_min(0).reshape(L, -1).long(),
        pmask.reshape(L, -1).to(torch.int32), "amax")
    n_tc, n_cl = vtc_mod.invalidation_counts(st.vtc, slot)
    btab.unmap_request(bt, slot, where=where)
    vtc_mod.invalidate_request(st.vtc, slot, where=where)
    st.slot_len[lane, slot] = torch.where(m, 0, st.slot_len[lane, slot])
    st.slot_live[lane, slot] &= ~m
    return st, torch.where(m, n_tc + n_cl, 0)


def retire(st: EngineState, slot, scope: str | None = None) -> EngineState:
    """Finish a request in every lane: shootdown — unmap pages,
    invalidate translations — and count the invalidations."""
    st, n_inval = _retire_one(st, slot)
    obs.count(scoped(obs.names.CTR_VTC_INVALIDATE, scope),
              int(n_inval.sum()))
    return st


def retire_where(st: EngineState, mask):
    """Batch shootdown of every slot where ``mask`` [L, n_slots] is True,
    slot after slot.  Returns ``(state, n_invalidated [L])``; slots
    retired in no lane are skipped."""
    L = st.slot_len.shape[0]
    total = torch.zeros(L, dtype=torch.int32, device=st.slot_len.device)
    for i in mask.any(0).nonzero().flatten().tolist():
        st, n = _retire_one(st, i, where=mask[:, i])
        total += n
    return st, total


def _grow(st: EngineState, pos: torch.Tensor, blocks: torch.Tensor):
    """The decode tick's page growth, in place: every live slot at a page
    boundary maps a fresh page for block ``blocks[i]`` — the slots in
    order, each the lowest page still free, as the reference's scan over
    slots takes them; a slot that finds the pool empty stalls.  Leaf
    rows are allocated the same way, in slot order.  Returns the stalled
    mask [L, n]."""
    bt = st.bt
    L, n = pos.shape
    dev = pos.device
    lane = torch.arange(L, device=dev)[:, None]
    slots = torch.arange(n, device=dev)[None, :]
    need = st.slot_live & (pos % btab.TOKENS_PER_PAGE == 0)
    k = need.to(torch.int32).cumsum(1, dtype=torch.int32) \
        - need.to(torch.int32)                    # needing slots before
    take = need & (k < st.page_free.sum(1, keepdim=True,
                                         dtype=torch.int32))
    page = _kth_free(st.page_free, k).to(torch.int32)
    _take_lowest(st.page_free, take.sum(1, dtype=torch.int32))
    # map_block for each taking slot: leaf rows in slot order
    max_dir = bt.directory.shape[2]
    dslot = (blocks >> btab.FANOUT_BITS).long()
    inb = dslot < max_dir
    dslot = dslot.clamp_max(max_dir - 1)
    leaf_row = bt.directory[lane, slots, dslot]
    alloc = take & (leaf_row < 0)
    k2 = alloc.to(torch.int32).cumsum(1, dtype=torch.int32) \
        - alloc.to(torch.int32)
    fresh = _kth_free(bt.leaf_free, k2)
    # with no free row left, argmax of an all-zero vector is row 0
    fresh = torch.where(fresh < bt.leaf_free.shape[1], fresh, 0)
    row = torch.where(alloc, fresh.to(torch.int32), leaf_row)
    _take_lowest(bt.leaf_free, alloc.sum(1, dtype=torch.int32))
    bt.directory[lane, slots, dslot] = torch.where(take & inb, row,
                                                   leaf_row)
    _put_last(bt.leaves, row.clamp_min(0).long() * btab.FANOUT
              + (blocks & (btab.FANOUT - 1)).long(), page, take)
    return need & ~take


def _put_last(table: torch.Tensor, flat: torch.Tensor, vals: torch.Tensor,
              mask: torch.Tensor) -> None:
    """``table.view(L, -1)[l, flat[l, i]] = vals[l, i]`` for the entries
    where `mask` holds, in place; where two entries hit one position the
    later one wins, as a sequence of writes would have it."""
    L = table.shape[0]
    tv = table.view(L, -1)
    N = tv.shape[1]
    order = torch.arange(flat.shape[1], device=flat.device).expand(L, -1)
    win = torch.full((L, N + 1), -1, dtype=torch.long, device=flat.device)
    win.scatter_reduce_(1, torch.where(mask, flat, N),
                        torch.where(mask, order, -1), "amax")
    win = win[:, :N]
    tv.copy_(torch.where(win >= 0, vals.gather(1, win.clamp_min(0)), tv))


def decode_translate(st: EngineState, cfg: EngineConfig):
    """One decode tick's translation work: every live slot translates the
    block holding its current position (+ appends a page on boundary).
    Returns (state, phys_pages [L, n_slots], src [L, n_slots]).

    Slots that hit a page boundary with an EXHAUSTED pool stall this
    tick (no growth, no translation, no length advance — retried next
    tick); parked (non-live) slots never enter the translation batch.
    ``src`` is -1 for stalled/parked slots.
    """
    L, n = st.slot_len.shape
    dev = st.slot_len.device
    pos = st.slot_len.clone()
    blocks = pos // btab.TOKENS_PER_PAGE
    stalled = _grow(st, pos, blocks)

    active = st.slot_live & ~stalled
    # paged attention reads the WHOLE context per token — translate the
    # current block plus two sampled context blocks (int32 products,
    # floor modulo as in the reference)
    nblk = blocks.clamp_min(1)
    h1 = torch.remainder(pos * 48271, nblk).to(torch.int32)
    h2 = torch.remainder((pos + 7) * 40503, nblk).to(torch.int32)
    reqs = torch.arange(n, dtype=torch.int32, device=dev).repeat(3)
    reqs = reqs.expand(L, -1)
    blks = torch.cat([blocks, h1, h2], 1)
    deep = active & (blocks > 0)
    valid = torch.cat([active, deep, deep], 1)
    _, _, phys_all, src_all = vtc_mod.translate_batch(
        st.vtc, st.bt, reqs, blks, st.pressure, valid=valid,
        gate=(cfg.gate_freq_min, cfg.gate_cost_min))
    phys, src = phys_all[:, :n], src_all[:, :n]

    # sampled-window pressure (paper §5.3): accumulate this tick's
    # walk/total into the epoch window; at the epoch boundary latch
    # pressure from the WINDOW's walk rate (float32) and reset
    win_walk = st.win_walk + (src_all == 2).sum(1, dtype=torch.int32)
    win_total = st.win_total + (src_all >= 0).sum(1, dtype=torch.int32)
    st.tick.add_(1)
    boundary = (st.tick % cfg.pressure_epoch) == 0
    rate = win_walk.float() / win_total.clamp_min(1).float()
    thresh = torch.tensor(cfg.pressure_thresh, dtype=torch.float32,
                          device=dev)
    st.pressure.copy_(torch.where(boundary, rate > thresh, st.pressure))
    st.win_walk.copy_(torch.where(boundary, 0, win_walk))
    st.win_total.copy_(torch.where(boundary, 0, win_total))
    st.slot_len.copy_(torch.where(active, pos + 1, pos))
    st.n_pool_stall.add_(stalled.sum(1, dtype=torch.int32))
    return st, phys, src


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def decode_step(st: EngineState, cfg: EngineConfig, fn=None,
                scope: str | None = None):
    """One TIMED decode tick: the instrumented serving entry point.

    Runs ``fn(state)`` (default: ``decode_translate`` under this `cfg`)
    inside a ``serve.decode_step`` span, waits for the device so the
    measured latency is real device time, and feeds the obs registry:
    the decode-step latency histogram and the step counter.
    """
    if fn is None:
        fn = lambda s: decode_translate(s, cfg)  # noqa: E731
    with obs.span(obs.names.SPAN_DECODE_STEP):
        t0 = time.perf_counter()
        out = fn(st)
        sync(st.slot_len.device)
        obs.observe(scoped(obs.names.HIST_DECODE_STEP_S, scope),
                    time.perf_counter() - t0)
    obs.count(scoped(obs.names.CTR_DECODE_STEPS, scope))
    return out


def stats(st: EngineState, scope: str | None = None) -> dict:
    """Engine-level snapshot (summed over lanes), routed through the obs
    registry.

    VTC counters live in device state (cumulative), so sampling here
    raises the registry counters monotonically (``inc_to``) rather than
    double-counting; pool/slot occupancy land as gauges.  Pass ``scope``
    when more than one engine lives in the process.
    """
    v = vtc_mod.stats(st.vtc)
    pages_free = int(st.page_free.sum())
    slot_occ = float(st.slot_live.float().mean())
    pool_stall = int(st.n_pool_stall.sum())
    obs.REGISTRY.inc_to(
        scoped(obs.names.CTR_VTC_HIT_TC, scope), v["n_hit_tc"])
    obs.REGISTRY.inc_to(
        scoped(obs.names.CTR_VTC_HIT_CLUSTER, scope), v["n_hit_cluster"])
    obs.REGISTRY.inc_to(
        scoped(obs.names.CTR_VTC_WALK, scope), v["n_walk"])
    obs.REGISTRY.inc_to(
        scoped(obs.names.CTR_POOL_EXHAUSTED, scope), pool_stall)
    obs.gauge(scoped(obs.names.GAUGE_PAGES_FREE, scope), pages_free)
    obs.gauge(scoped(obs.names.GAUGE_SLOT_OCCUPANCY, scope), slot_occ)
    return {
        "tc_hit_rate": v["tc_hit_rate"],
        "cluster_hit_rate": v["cluster_hit_rate"],
        "walk_rate": v["walk_rate"],
        "vtc_hit_rate": v["vtc_hit_rate"],
        "pages_free": pages_free,
        "slot_occupancy": slot_occ,
        "pool_stall": pool_stall,
        "pressure": bool(st.pressure.any()),
        "invalidate_count": obs.REGISTRY.counter(
            scoped(obs.names.CTR_VTC_INVALIDATE, scope)),
    }
