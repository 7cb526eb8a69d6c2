"""Victima Translation Cache (VTC) — the paper's mechanism on the serving
side; port of ``repro.paged.translation_cache``.

Three tiers mirror the paper's hierarchy:

  1. TC  — small set-associative translation cache (the "L2 TLB"):
     (req, block) → phys page.
  2. **Translation cluster pages** — Victima's key idea transplanted:
     *unused pages of the KV pool itself* are retagged to hold clusters of
     CLUSTER=8 leaf translations.  A cluster hit costs ONE gather instead
     of the 2-hop radix walk (paper: one L2 access instead of a PTW).
  3. Radix walk (``block_table.walk``) — the slow path; updates the
     per-leaf (freq, cost) counters.

Insertion is gated by the paper's PTW-CP comparator on those counters,
and the pool eviction policy is TLB-aware SRRIP: cluster pages are
protected while TC pressure is high.

All state is integer tensors with a leading lane axis ``[lanes]`` (one
engine a lane).  ``translate`` handles one (req, block) per lane and
updates the VTC and the block tables IN PLACE, in the reference's order
of reads and writes; a lane masked out by ``valid`` touches no state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.assoc import RRIP_MAX
from repro_torch.paged import block_table as btab

CLUSTER = 8  # translations per cluster line (paper: 8 PTEs / 64B block)
# Knuth's multiplicative hash constant as the int32 the reference uses
_HASH_MUL = -1640531535


class VTC(NamedTuple):
    # tier 1: set-associative TC
    tc_tags: torch.Tensor      # int32 [L, S, W]  key = (req << 20) | block
    tc_phys: torch.Tensor      # int32 [L, S, W]
    tc_valid: torch.Tensor     # bool  [L, S, W]
    tc_stamp: torch.Tensor     # int32 [L, S, W]
    # tier 2: cluster pages carved from the KV pool
    cl_tags: torch.Tensor      # int32 [L, n_cl]  key = (req<<20|block) >> 3
    cl_phys: torch.Tensor      # int32 [L, n_cl, CLUSTER]
    cl_valid: torch.Tensor     # bool  [L, n_cl]
    cl_rrpv: torch.Tensor      # int32 [L, n_cl]
    # stats
    n_hit_tc: torch.Tensor     # int32 [L]
    n_hit_cluster: torch.Tensor
    n_walk: torch.Tensor
    now: torch.Tensor


def _pow2(v: int) -> bool:
    return v >= 1 and (v & (v - 1)) == 0


def make(tc_sets: int = 64, tc_ways: int = 4, n_clusters: int = 256,
         lanes: int = 1, device=None) -> VTC:
    """An empty VTC for `lanes` engines on `device` (default: the card).

    ``translate`` indexes sets with ``key & (S - 1)`` and hashes clusters
    by the top ``log2(n_clusters)`` product bits — both silently
    mis-index unless the counts are powers of two, so anything else is
    rejected.  n_clusters=1 (2^0) is the valid no-cluster ablation.
    """
    if not _pow2(tc_sets):
        raise ValueError(
            f"tc_sets must be a power of two (set indexing is "
            f"`key & (tc_sets - 1)`), got {tc_sets}")
    if not _pow2(n_clusters):
        raise ValueError(
            f"n_clusters must be a power of two (the cluster hash takes "
            f"the top `log2(n_clusters)` product bits), got {n_clusters}")
    if tc_ways < 1:
        raise ValueError(f"tc_ways must be >= 1, got {tc_ways}")
    from repro_torch.core.mmu import resolve_device
    dev = resolve_device(device)

    def full(shape, v, dtype=torch.int32):
        return torch.full((lanes,) + shape, v, dtype=dtype, device=dev)

    tc = (tc_sets, tc_ways)
    return VTC(
        tc_tags=full(tc, 0), tc_phys=full(tc, 0),
        tc_valid=full(tc, False, torch.bool), tc_stamp=full(tc, 0),
        cl_tags=full((n_clusters,), 0),
        cl_phys=full((n_clusters, CLUSTER), -1),
        cl_valid=full((n_clusters,), False, torch.bool),
        cl_rrpv=full((n_clusters,), RRIP_MAX),
        n_hit_tc=full((), 0), n_hit_cluster=full((), 0),
        n_walk=full((), 0), now=full((), 0),
    )


def _key(req, block):
    return (req << 20) | block


def cluster_slot(ckey: torch.Tensor, n_cl: int) -> torch.Tensor:
    """The cluster slot of each cluster key: the TOP ``log2(n_cl)`` bits
    of the wrapped int32 product ``ckey * -1640531535``, read as
    unsigned (the reference's logical right shift).  The product is
    taken in int64 and masked to 32 bits first, since torch has no
    logical shift on int32.  ``n_cl == 1`` is slot 0."""
    nbits = (n_cl - 1).bit_length()
    if nbits == 0:
        return torch.zeros_like(ckey, dtype=torch.long)
    prod = (ckey.long() * _HASH_MUL) & 0xFFFFFFFF
    return (prod >> (32 - nbits)) & (n_cl - 1)


def translate(vtc: VTC, bt: btab.BlockTables, req, block, pressure,
              gate: tuple = (1, 1), valid: torch.Tensor | None = None):
    """Full Victima translation flow for one (req, block) per lane.

    Returns (vtc, bt, phys_page, source), `phys_page` and `source`
    ``[L]`` with source 0=TC, 1=cluster, 2=walk (-1 and -1 in a lane
    masked out by `valid`, whose state is left untouched).  State
    updates mirror the paper §5.2/§5.3: miss in TC → probe cluster pages
    ∥ start walk; on walk completion the PTW-CP gate decides whether to
    install the 8-translation cluster; TC refill always happens.

    ``gate = (freq_min, cost_min)`` are the PTW-CP cluster-install lower
    bounds; ``(0, 0)`` is install-always.  `pressure` is a per-lane bool.
    A batch of one: see ``translate_batch``.
    """
    L = vtc.tc_tags.shape[0]
    dev = vtc.tc_tags.device
    req = btab.lane_arg(req, L, dev)[:, None]
    block = btab.lane_arg(block, L, dev)[:, None]
    _, _, phys, src = translate_batch(
        vtc, bt, req, block, pressure,
        None if valid is None else valid[:, None], gate)
    return vtc, bt, phys[:, 0], src[:, 0]


class _Plan(NamedTuple):
    """A batch's state-independent quantities, ``[n, L]`` (``[n, L, k]``
    for rows; entry-major, so each entry's slice is contiguous), computed
    once before the sequential loop: flat indices into the lane-batched
    tables and the entries' keys and stamps."""
    key: torch.Tensor      # int32 TC key
    ckey: torch.Tensor     # int32 cluster key
    tc_row: torch.Tensor   # int64 [n, L, W] the key's TC set, flat
    cl: torch.Tensor       # int64 the key's cluster slot, flat
    cl_row: torch.Tensor   # int64 [n, L, CLUSTER] its cl_phys row, flat
    cl_ent: torch.Tensor   # int64 its cl_phys entry, flat
    dir: torch.Tensor      # int64 its directory entry, flat
    leaf: torch.Tensor     # int64 leaf entry, flat, less 64 * leaf row
    leaf8: torch.Tensor    # int64 [n, L, CLUSTER] the cluster's entries
    row0: torch.Tensor     # int64 [L] first leaf row of each lane
    now: torch.Tensor      # int32 the VTC clock at each entry


def _plan(vtc: VTC, bt: btab.BlockTables, reqs, blocks, valid) -> _Plan:
    L, S, W = vtc.tc_tags.shape
    n_cl = vtc.cl_tags.shape[1]
    _, R, max_dir = bt.directory.shape
    rows = bt.leaves.shape[1]
    dev = blocks.device
    lane = torch.arange(L, device=dev)[:, None]
    reqs = reqs.to(torch.int32)
    blocks = blocks.to(torch.int32)
    key = _key(reqs, blocks)
    ckey = key >> 3
    cl = lane * n_cl + cluster_slot(ckey, n_cl)
    ar_w = torch.arange(W, device=dev)
    ar_c = torch.arange(CLUSTER, device=dev)
    dslot = (blocks >> btab.FANOUT_BITS).long().clamp(0, max_dir - 1)
    col = (blocks & (btab.FANOUT - 1)).long()
    leaf0 = lane * (rows * btab.FANOUT)
    # the VTC clock: +1 at each entry a lane translates
    now = vtc.now[:, None] + valid.to(torch.int32).cumsum(
        1, dtype=torch.int32)
    plan = _Plan(
        key=key, ckey=ckey,
        tc_row=((lane * S + (key & (S - 1)).long()) * W)[..., None] + ar_w,
        cl=cl, cl_row=(cl * CLUSTER)[..., None] + ar_c,
        cl_ent=cl * CLUSTER + (blocks & (CLUSTER - 1)).long(),
        dir=(lane * R + reqs.long()) * max_dir + dslot,
        leaf=leaf0 + col,
        leaf8=(leaf0 + (col & ~(CLUSTER - 1)))[..., None] + ar_c,
        row0=lane * rows, now=now)
    return _Plan(*[x[:, 0] if f == "row0" else x.transpose(0, 1).contiguous()
                   for f, x in zip(_Plan._fields, plan)])


def translate_batch(vtc: VTC, bt: btab.BlockTables, reqs, blocks, pressure,
                    valid=None, gate: tuple = (1, 1)):
    """Sequential batch translation — the scheduler-side path.

    `reqs`, `blocks` and `valid` are ``[L, n]``: entry ``i`` of every
    lane translates in order, each as the reference's ``translate``
    does, reading and writing the state in the same order.  A masked
    entry touches NO state — no counters, no refills, no walk side
    effects — and reports ``phys = -1, src = -1``; an entry masked in
    every lane is skipped (one host read of `valid` decides which).
    Returns (vtc, bt, phys [L, n], src [L, n]), in place.

    What depends only on the inputs (keys, set and cluster slots, flat
    indices, the clock at each entry) is computed for the whole batch
    first, and the hit counters are added at the end; the loop reads
    each touched row of the state once (``take``), decides, and writes
    it back once (``put_``).  A TC set holds a valid key at most once
    (a refill only follows a miss), so the hit mask itself marks the
    hit way.
    """
    L, n = blocks.shape
    dev = blocks.device
    if valid is None:
        valid = torch.ones((L, n), dtype=torch.bool, device=dev)
    pl = _plan(vtc, bt, reqs, blocks, valid)
    pressure = pressure.expand(L)
    dec = torch.where(pressure, 3, 1).to(torch.int32)
    fresh_rrpv = torch.where(pressure, 0, RRIP_MAX - 1).to(torch.int32)
    g_f, g_c = int(gate[0]), int(gate[1])
    ar_w = torch.arange(vtc.tc_tags.shape[2], device=dev)
    no_hit = torch.zeros(L, dtype=torch.bool, device=dev)
    outs = [(torch.full((L,), -1, dtype=torch.int32, device=dev), no_hit,
             no_hit)] * n
    tt_, tp_, tv_, ts_ = vtc.tc_tags, vtc.tc_phys, vtc.tc_valid, \
        vtc.tc_stamp
    vh = valid.cpu()
    live, every = vh.any(0).tolist(), vh.all(0).tolist()
    valid_t = valid.t().contiguous()
    for i in range(n):
        if not live[i]:
            continue
        ok = None if every[i] else valid_t[i]
        key, ckey, now = pl.key[i], pl.ckey[i], pl.now[i]
        ridx, cidx = pl.tc_row[i], pl.cl[i]
        # tier 1: the TC set
        tt, tp, tv, ts = (x.take(ridx) for x in (tt_, tp_, tv_, ts_))
        hit_w = tv & (tt == key[:, None])
        tc_hit = hit_w.any(1)
        if ok is not None:
            hit_w = hit_w & ok[:, None]
        ts = torch.where(hit_w, now[:, None], ts)
        # tier 2: cluster probe (direct-mapped on the cluster key); a
        # cluster may hold FREE for blocks mapped after its install
        clv = vtc.cl_valid.take(cidx)
        clt = vtc.cl_tags.take(cidx)
        rr = vtc.cl_rrpv.take(cidx)
        p_cl = vtc.cl_phys.take(pl.cl_ent[i])
        cl_hit = clv & (clt == ckey) & (p_cl >= 0) & ~tc_hit
        cl_w = cl_hit if ok is None else cl_hit & ok
        # cluster hit promotion (TLB-aware: -3 under pressure)
        rr = torch.where(cl_w, (rr - dec).clamp_min(0), rr)
        # tier 3: radix walk, and the PTW-CP counters of its leaf row
        need_walk = ~(tc_hit | cl_hit)
        walk_w = need_walk if ok is None else need_walk & ok
        leaf_row = bt.directory.take(pl.dir[i])
        mapped = leaf_row >= 0
        row = leaf_row.clamp_min(0)
        lidx = torch.add(pl.leaf[i], row, alpha=btab.FANOUT)
        p_walk = torch.where(mapped, bt.leaves.take(lidx), btab.FREE)
        fidx = pl.row0 + row
        f0, c0 = bt.walk_freq.take(fidx), bt.walk_cost.take(fidx)
        f = torch.where(walk_w, (f0 + 1).clamp_max(7), f0)
        c = torch.where(walk_w, (c0 + mapped).clamp_max(15), c0)
        bt.walk_freq.put_(fidx, f)
        bt.walk_cost.put_(fidx, c)
        # PTW-CP gate → install the cluster of 8 neighbours (they share
        # the block's directory slot, hence its leaf row)
        install = walk_w & (f >= g_f) & (c >= g_c)
        nphys = torch.where(
            mapped[:, None],
            bt.leaves.take(torch.add(pl.leaf8[i], row[:, None],
                                     alpha=btab.FANOUT)), btab.FREE)
        # TLB-aware eviction: under pressure a valid cluster with low
        # RRPV resists, and a blocked install AGES the slot (SRRIP)
        resist = clv & pressure & (rr < RRIP_MAX)
        do_install = install & ~resist
        rr = (rr + (install & resist)).clamp_max(RRIP_MAX)
        vtc.cl_rrpv.put_(cidx, torch.where(do_install, fresh_rrpv, rr))
        vtc.cl_tags.put_(cidx, torch.where(do_install, ckey, clt))
        vtc.cl_valid.put_(cidx, clv | do_install)
        crow = pl.cl_row[i]
        vtc.cl_phys.put_(crow, torch.where(do_install[:, None], nphys,
                                           vtc.cl_phys.take(crow)))
        p = torch.where(tc_hit, torch.where(hit_w, tp, 0).sum(
            1, dtype=torch.int32), torch.where(cl_hit, p_cl, p_walk))
        # TC refill (LRU victim) on any miss
        miss = ~tc_hit if ok is None else ~tc_hit & ok
        victim = (ar_w == torch.where(tv, ts, -1).argmin(1)[:, None]) \
            & miss[:, None]
        tt_.put_(ridx, torch.where(victim, key[:, None], tt))
        tp_.put_(ridx, torch.where(victim, p[:, None], tp))
        tv_.put_(ridx, tv | victim)
        ts_.put_(ridx, torch.where(victim, now[:, None], ts))
        outs[i] = (p, tc_hit, cl_hit)
    phys, tc_hits, cl_hits = (torch.stack(x, 1) for x in zip(*outs))
    tc_hits &= valid
    cl_hits &= valid
    walks = valid & ~tc_hits & ~cl_hits
    vtc.n_hit_tc.add_(tc_hits.sum(1, dtype=torch.int32))
    vtc.n_hit_cluster.add_(cl_hits.sum(1, dtype=torch.int32))
    vtc.n_walk.add_(walks.sum(1, dtype=torch.int32))
    vtc.now.add_(valid.sum(1, dtype=torch.int32))
    src = torch.where(tc_hits, 0, torch.where(cl_hits, 1, 2)).to(
        torch.int32)
    return (vtc, bt, torch.where(valid, phys, -1),
            torch.where(valid, src, -1))


def _shootdown_masks(vtc: VTC, req):
    L = vtc.tc_tags.shape[0]
    r = btab.lane_arg(req, L, vtc.tc_tags.device)
    tmask = (vtc.tc_tags >> 20) == r[:, None, None]
    cmask = (vtc.cl_tags >> 17) == r[:, None]  # ckey = key>>3: req at 17
    return tmask, cmask


def invalidation_counts(vtc: VTC, req):
    """How many live entries a shootdown of `req` would invalidate, per
    lane: ``(n_tc, n_cluster)``, int32 ``[L]`` tensors."""
    tmask, cmask = _shootdown_masks(vtc, req)
    return ((vtc.tc_valid & tmask).sum((1, 2), dtype=torch.int32),
            (vtc.cl_valid & cmask).sum(1, dtype=torch.int32))


def invalidate_request(vtc: VTC, req,
                       where: torch.Tensor | None = None) -> VTC:
    """Shootdown flow (paper §6): request eviction invalidates its TC
    entries and cluster pages by tag match on the request id.  In place;
    lanes where `where` is False are untouched."""
    tmask, cmask = _shootdown_masks(vtc, req)
    if where is not None:
        tmask = tmask & where[:, None, None]
        cmask = cmask & where[:, None]
    vtc.tc_valid.logical_and_(~tmask)
    vtc.cl_valid.logical_and_(~cmask)
    return vtc


def stats(vtc: VTC) -> dict:
    """Host-side counter snapshot (plain ints/floats, safe to serialize),
    summed over the lanes.

    ``vtc_hit_rate`` is the paper's translation-reach headline for the
    serving tiers: the fraction of translations served WITHOUT a radix
    walk (TC hits + cluster hits).
    """
    hit_tc = int(vtc.n_hit_tc.sum())
    hit_cl = int(vtc.n_hit_cluster.sum())
    walks = int(vtc.n_walk.sum())
    tot = max(hit_tc + hit_cl + walks, 1)
    return {
        "n_hit_tc": hit_tc,
        "n_hit_cluster": hit_cl,
        "n_walk": walks,
        "tc_hit_rate": hit_tc / tot,
        "cluster_hit_rate": hit_cl / tot,
        "walk_rate": walks / tot,
        "vtc_hit_rate": (hit_tc + hit_cl) / tot,
        "tc_occupancy": float(vtc.tc_valid.float().mean()),
        "cl_occupancy": float(vtc.cl_valid.float().mean()),
    }
