"""Cache hierarchy model: L1D (LRU), L2 (SRRIP + Victima TLB blocks), L3
(SRRIP); lane-batched port of ``repro.core.caches``.

The L2 cache is the structure Victima modifies (§5.1 of the paper): each
block carries a *block type* —

    BT_DATA = 0   conventional data block (tag = physical line id)
    BT_TLB4 = 1   TLB block, 8 PTEs for 8 contiguous 4K pages (tag = vpn>>3)
    BT_TLB2 = 2   TLB block for 2M pages                      (tag = vpn2m>>3)
    BT_NTLB = 3   nested TLB block (virt.), 8 host leaf PTEs  (tag = gpn>>3)

Tag matching always requires the block type to match.  Reuse histograms
(Figs. 11 & 24) and live TLB-block counts (Fig. 23 reach) are folded into
the cache state on insert/evict.  Every array has a leading lane axis and
is updated in place (see ``repro_torch.core.assoc``).  The L2 cache
takes a per-lane view geometry (``L2Geom``) for ladder-batched runs.
A die-stacked DRAM cache below the L3 (an SRRIP ``Assoc``, sized 1 when
the configuration has none) is probed on an L3 miss when the caller
passes its gate (``stages.base.dramc_of``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.assoc import (RRIP_MAX, Assoc, as_mask, idle,
                                    insert_lru, lane_ids, lane_offsets,
                                    lookup, make, row_offsets, set_index,
                                    srrip_age_and_pick,
                                    srrip_victim_tlb_aware, touch_lru,
                                    way_mask)

BT_DATA, BT_TLB4, BT_TLB2, BT_NTLB = 0, 1, 2, 3
REUSE_BUCKETS = 22  # reuse counts 0..20, bucket 21 = ">20" overflow


class L2Geom(NamedTuple):
    """Per-lane view geometry of a dynamically sized L2 cache.

    A ladder-batched run allocates the L2 at the ladder's maximum shape;
    each lane's live geometry is a set mask plus an effective way count
    (``[W]`` int32 each).  Every insert masks its set index and picks
    its victim among the ways below ``n_ways``, so the view equals a
    statically allocated (live_sets, n_ways) cache.  ``geom=None``
    everywhere below is the static path.
    """

    set_mask: torch.Tensor  # int32 [W] = live sets - 1
    n_ways: torch.Tensor    # int32 [W] effective ways


def _l2_set(l2: "L2Cache", key, geom: L2Geom | None) -> torch.Tensor:
    if geom is None:
        return set_index(key, l2.n_sets)
    return (key & geom.set_mask).long()


def _way_ok(l2: "L2Cache", geom: L2Geom | None):
    return None if geom is None else way_mask(geom.n_ways,
                                              l2.tags.shape[2])


class L2Cache(NamedTuple):
    tags: torch.Tensor    # int32 [W, S, ways]
    valid: torch.Tensor   # bool  [W, S, ways]
    rrpv: torch.Tensor    # int32 [W, S, ways]
    btype: torch.Tensor   # int32 [W, S, ways]
    reuse: torch.Tensor   # int32 [W, S, ways]
    hist_reuse_data: torch.Tensor  # int32 [W, REUSE_BUCKETS]
    hist_reuse_tlb: torch.Tensor   # int32 [W, REUSE_BUCKETS]
    n_tlb4: torch.Tensor  # int32 [W] — live TLB blocks (4K)
    n_tlb2: torch.Tensor  # int32 [W] — live TLB blocks (2M)
    n_ntlb: torch.Tensor  # int32 [W] — live nested TLB blocks

    @property
    def n_sets(self) -> int:
        return self.tags.shape[1]


def make_l2(n_sets: int, n_ways: int, lanes: int = 1, device="cpu"
            ) -> L2Cache:
    def z(*shape, dtype=torch.int32):
        return torch.zeros((lanes,) + shape, dtype=dtype, device=device)

    return L2Cache(
        tags=z(n_sets, n_ways), valid=z(n_sets, n_ways, dtype=torch.bool),
        rrpv=z(n_sets, n_ways), btype=z(n_sets, n_ways),
        reuse=z(n_sets, n_ways),
        hist_reuse_data=z(REUSE_BUCKETS), hist_reuse_tlb=z(REUSE_BUCKETS),
        n_tlb4=z(), n_tlb2=z(), n_ntlb=z(),
    )


def _col(bt):
    """A block type as a row-broadcastable value (int or [W, 1])."""
    return bt[:, None] if isinstance(bt, torch.Tensor) else bt


def _add_live(l2: L2Cache, bt, delta: torch.Tensor) -> None:
    """Add `delta` to the live count of block type `bt` (int or [W])."""
    for cnt, code in ((l2.n_tlb4, BT_TLB4), (l2.n_tlb2, BT_TLB2),
                      (l2.n_ntlb, BT_NTLB)):
        if not isinstance(bt, torch.Tensor):
            if bt == code:
                cnt.add_(delta)
        else:
            cnt.add_(delta * (bt == code))


def l2_lookup(l2: L2Cache, key, btype, geom: L2Geom | None = None):
    # no way mask on a probe: inserts never touch ways past the view's
    # limit, so those ways are never valid
    s = _l2_set(l2, key, geom)
    ln = lane_ids(key)
    hits = (l2.valid[ln, s] & (l2.tags[ln, s] == key[:, None])
            & (l2.btype[ln, s] == _col(btype)))
    return hits.any(1), hits.to(torch.uint8).argmax(1), s


def l2_touch(l2: L2Cache, s, w, pressure, tlb_aware: bool, enable
             ) -> L2Cache:
    """Hit-promotion per paper Listing 1 `updateOnL2CacheHit`.

    TLB blocks under pressure decrement RRPV by 3, everything else by 1.
    Reuse counter increments (for Figs. 11/24).
    """
    en = as_mask(enable, s)
    if idle(en):
        return l2
    e = row_offsets(l2.rrpv, s) + w
    old = l2.rrpv.take(e)
    if tlb_aware:
        dec = 1 + 2 * ((l2.btype.take(e) != BT_DATA) & pressure).int()
    else:
        dec = 1
    l2.rrpv.put_(e, torch.where(en, (old - dec).clamp_min(0), old))
    l2.reuse.put_(e, en.int(), accumulate=True)
    return l2


def _account_evict(l2: L2Cache, bt, valid, reuse, evicting) -> None:
    """Histogram + live-count bookkeeping for the block being replaced:
    `bt`, `valid` and `reuse` are its fields read before the insert."""
    was_valid = valid & evicting
    bucket = (lane_offsets(l2.hist_reuse_data)
              + reuse.clamp_max(REUSE_BUCKETS - 1))
    is_data = bt == BT_DATA
    l2.hist_reuse_data.put_(bucket, (was_valid & is_data).int(),
                            accumulate=True)
    gone = was_valid & ~is_data
    if idle(gone):
        return
    l2.hist_reuse_tlb.put_(bucket, gone.int(), accumulate=True)
    _add_live(l2, bt, -gone.int())


def l2_insert(l2: L2Cache, key, btype, pressure, tlb_aware: bool, enable,
              geom: L2Geom | None = None) -> L2Cache:
    """Insert a block (Listing 1 `insertBlockInL2` + victim selection).

    Inserted TLB blocks under pressure get RRPV=0; everything else the
    standard SRRIP long re-reference interval (RRIP_MAX-1).
    Evicted TLB blocks are dropped (paper §5.1).  The evicted block is
    accounted from the row read before the insert, and the aged row is
    written back only when enabled.
    """
    en = as_mask(enable, key)
    if idle(en):
        return l2
    s = _l2_set(l2, key, geom)
    way_ok = _way_ok(l2, geom)
    ln = lane_ids(key)
    row_rrpv, row_valid = l2.rrpv[ln, s], l2.valid[ln, s]
    row_btype = l2.btype[ln, s]
    if tlb_aware:
        aged, w = srrip_victim_tlb_aware(row_rrpv, row_valid,
                                         row_btype != BT_DATA, pressure,
                                         way_ok)
    else:
        aged, w = srrip_age_and_pick(row_rrpv, row_valid, way_ok)
    e = row_offsets(l2.tags, s) + w
    old_bt, old_valid = l2.btype.take(e), l2.valid.take(e)
    old_reuse = l2.reuse.take(e)
    _account_evict(l2, old_bt, old_valid, old_reuse, en)

    if tlb_aware:
        ins_rrpv = (RRIP_MAX - 1) * (~(pressure & (btype != BT_DATA))).int()
        aged[ln, w] = ins_rrpv
    else:
        aged[ln, w] = RRIP_MAX - 1
    l2.tags.put_(e, torch.where(en, key, l2.tags.take(e)))
    l2.valid.put_(e, old_valid | en)
    l2.rrpv[ln, s] = torch.where(en[:, None], aged, row_rrpv)
    l2.btype.put_(e, torch.where(en, btype, old_bt))
    l2.reuse.put_(e, torch.where(en, 0, old_reuse))
    _add_live(l2, btype, en.int())
    return l2


def l2_retag_to_tlb(l2: L2Cache, key, btype, pressure, tlb_aware: bool,
                    enable, geom: L2Geom | None = None) -> L2Cache:
    """Victima §5.2: transform the cache line holding the fetched leaf PTEs
    into a TLB block, *unless* one already exists for this region
    (modeled as an insert at set(key), as in the reference)."""
    en = as_mask(enable, key)
    if idle(en):
        return l2
    exists, _, _ = l2_lookup(l2, key, btype, geom)
    return l2_insert(l2, key, btype, pressure, tlb_aware, en & ~exists,
                     geom)


# ---------------------------------------------------------------- L3 (SRRIP)


def l3_access(l3: Assoc, key, enable):
    """Probe L3; fill on miss. Returns (l3, hit).

    The SRRIP victim is aged and picked from the row AFTER the hit
    promotion; the aged row is written back only on an insert.
    """
    en = as_mask(enable, key)
    hit, w, s = lookup(l3, key)
    if idle(en):
        return l3, hit
    ln = lane_ids(key)
    rows = row_offsets(l3.meta, s)
    promote = hit & en
    if not idle(promote):
        l3.meta.put_(rows + w, torch.where(promote, 0, l3.meta.take(rows + w)))
    do_ins = en & ~hit
    if idle(do_ins):
        return l3, hit
    row_meta, row_valid = l3.meta[ln, s], l3.valid[ln, s]
    aged, vw = srrip_age_and_pick(row_meta, row_valid)
    aged[ln, vw] = RRIP_MAX - 1
    e = rows + vw
    l3.tags.put_(e, torch.where(do_ins, key, l3.tags.take(e)))
    l3.valid.put_(e, l3.valid.take(e) | do_ins)
    l3.meta[ln, s] = torch.where(do_ins[:, None], aged, row_meta)
    return l3, hit


# ---------------------------------------------------------------- hierarchy


class Hier(NamedTuple):
    l1d: Assoc
    l2: L2Cache
    l3: Assoc
    dramc: Assoc                # die-stacked DRAM cache (sized 1 when off)
    # running counters for MPKI-style signals
    n_l2_access: torch.Tensor   # int32 [W] — demand data accesses at L2
    n_l2_miss: torch.Tensor     # int32 [W]
    # shared-tier occupancy counters
    n_l3_access: torch.Tensor   # int32 [W]
    n_l3_trans: torch.Tensor    # int32 [W] — translation-typed L3 probes
    n_dramc_access: torch.Tensor  # int32 [W] — L3 misses probing the DRAM
    #                               cache
    n_dramc_hit: torch.Tensor     # int32 [W]


def make_hier(l1_sets=64, l1_ways=8, l2_sets=2048, l2_ways=16,
              l3_sets=2048, l3_ways=16, dramc_sets=1, dramc_ways=16,
              lanes: int = 1, device="cpu") -> Hier:
    def z():
        return torch.zeros((lanes,), dtype=torch.int32, device=device)

    return Hier(
        l1d=make(l1_sets, l1_ways, lanes, device),
        l2=make_l2(l2_sets, l2_ways, lanes, device),
        l3=make(l3_sets, l3_ways, lanes, device),
        dramc=make(dramc_sets, dramc_ways, lanes, device),
        n_l2_access=z(), n_l2_miss=z(), n_l3_access=z(), n_l3_trans=z(),
        n_dramc_access=z(), n_dramc_hit=z(),
    )


class Lat(NamedTuple):
    """Latency constants (cycles), Table 3 + calibration."""

    l1d: int = 4
    l2: int = 16
    l3: int = 35
    dram: int = 160  # full DRAM round trip (beyond L3 probe)
    dramc: int = 58  # die-stacked DRAM-cache hit (beyond the L3 probe)


def _dramc_probe(h: Hier, line, miss3, lat: Lat, dramc):
    """Probe the die-stacked DRAM cache on an L3 miss (SRRIP, as the L3:
    ``l3_access`` on ``h.dramc``).

    ``dramc`` is the gate (``stages.base.dramc_of``): None leaves the
    probe out, and a False lane masks it off bit-exactly.  Returns
    (miss_cyc, dram): the cycles beyond the L3 probe and the accesses
    that still went to main memory (a DRAM-cache hit never left the
    package)."""
    if dramc is None:
        return lat.dram, miss3
    gate = as_mask(dramc, line) & miss3
    _, hitd = l3_access(h.dramc, line, gate)
    h.n_dramc_access.add_(gate.int())
    h.n_dramc_hit.add_((gate & hitd).int())
    dram = miss3 & ~(gate & hitd)
    miss_cyc = torch.where(gate, lat.dramc + lat.dram * (~hitd).int(),
                           lat.dram)
    return miss_cyc, dram


def _miss_cycles(hit2, hit3, lat: Lat, miss_cyc) -> torch.Tensor:
    return torch.where(hit2, lat.l2, torch.where(hit3, lat.l3,
                                                 lat.l3 + miss_cyc))


# salts of the two background lines per access (int32 constants)
_BG_MUL = -1640531527
_BG_SALTS = (-1640531527, -2048144789)
_BG_MASK = (1 << 26) - 1


def access_data(h: Hier, line, now, pressure, tlb_aware: bool, lat: Lat,
                geom: L2Geom | None = None, dramc=None):
    """Demand data access L1D→L2→L3→[DRAM cache]→DRAM with fills.
    Returns (h, cycles).  ``dramc`` gates the DRAM-cache probe (None:
    absent).

    The L1D is touched unconditionally: on a miss this stamps way 0 of
    the set (the argmax of an all-false row), and the L1 fill then picks
    its victim from that touched row — the reference's behaviour.
    """
    hit1, w1, s1 = lookup(h.l1d, line)
    touch_lru(h.l1d, s1, w1, now)

    hit2, w2, s2 = l2_lookup(h.l2, line, BT_DATA, geom)
    go_l2 = ~hit1
    l2_touch(h.l2, s2, w2, pressure, tlb_aware, go_l2 & hit2)

    go_l3 = go_l2 & ~hit2
    _, hit3 = l3_access(h.l3, line, go_l3)
    # fill L2 on L2 miss (from L3 or DRAM)
    l2_insert(h.l2, line, BT_DATA, pressure, tlb_aware, go_l3, geom)
    # stream prefetcher at L2 (Table 3): next-line fill on L2 miss
    nxt = line + 1
    pf_hit, _, _ = l2_lookup(h.l2, nxt, BT_DATA, geom)
    l2_insert(h.l2, nxt, BT_DATA, pressure, tlb_aware, go_l3 & ~pf_hit,
              geom)
    # fill L1D on any L1 miss
    insert_lru(h.l1d, line, now, go_l2)

    # background traffic: two pseudo-random untracked lines per access
    # (see the reference's access_data for the calibration rationale);
    # the int32 product wraps around, as in the reference
    for salt in _BG_SALTS:
        bg_line = ((now * _BG_MUL) ^ salt) & _BG_MASK
        _, bg_hit3 = l3_access(h.l3, bg_line, True)
        l2_insert(h.l2, bg_line, BT_DATA, pressure, tlb_aware, ~bg_hit3,
                  geom)

    # the DRAM cache below the L3 (background lines never probe it: they
    # model pressure only and are never charged)
    miss_cyc, _ = _dramc_probe(h, line, go_l3 & ~hit3, lat, dramc)
    cycles = torch.where(hit1, lat.l1d,
                         _miss_cycles(hit2, hit3, lat, miss_cyc))
    h.n_l2_access.add_(go_l2.int())
    h.n_l2_miss.add_(go_l3.int())
    h.n_l3_access.add_(go_l3.int())
    return h, cycles.int()


def access_pte(h: Hier, line, pressure, tlb_aware: bool, lat: Lat, enable,
               bt: int = BT_DATA, geom: L2Geom | None = None, dramc=None):
    """Page-table-walker access (starts at L2). Returns (h, cycles, dram).

    ``dramc`` gates the DRAM-cache probe (None: absent); a DRAM-cache hit
    counts as ``dram=False``, which the PTW-CP counters read."""
    en = as_mask(enable, line)
    if idle(en):
        return h, torch.zeros_like(line), torch.zeros_like(en)
    hit2, w2, s2 = l2_lookup(h.l2, line, bt, geom)
    l2_touch(h.l2, s2, w2, pressure, tlb_aware, en & hit2)
    go_l3 = en & ~hit2
    _, hit3 = l3_access(h.l3, line, go_l3)
    l2_insert(h.l2, line, bt, pressure, tlb_aware, go_l3, geom)
    miss_cyc, dram = _dramc_probe(h, line, go_l3 & ~hit3, lat, dramc)
    cycles = torch.where(en, _miss_cycles(hit2, hit3, lat, miss_cyc), 0)
    h.n_l3_access.add_(go_l3.int())
    h.n_l3_trans.add_(go_l3.int())
    return h, cycles.int(), dram
