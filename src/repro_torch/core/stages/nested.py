"""Stage: nested-paging 2-D page-table walk (virtualized, paper §9.3);
port of ``repro.core.stages.nested``.

Every guest-PT access first resolves its own gPA -> hPA through the
nested TLB, optionally Victima's nested-TLB blocks in the L2 cache, and
finally a 4-level host walk.  The data page's own gPA is translated
last (identity gPA map: gpn = vpn).  The side effects keep the
reference's order exactly; the two host-page counter updates of one
translation (demand walk, then the nested-TLB eviction's background
walk) are two in-place writes, so the second wins when their indices
meet, as there.  With ``Dyn`` overrides the L2 cache is each lane's view,
and a lane whose ``victima_en`` is off probes no nested-TLB block and
installs none, and walks nothing in the background: a plain nested-paging
lane.
"""
from __future__ import annotations

import torch

from repro_torch.core import ptwcp
from repro_torch.core.assoc import as_mask, idle, insert_lru, lane_ids, lookup
from repro_torch.core.caches import (BT_NTLB, access_pte, l2_lookup,
                                     l2_retag_to_tlb, l2_touch)
from repro_torch.core.page_table import (LEAF4_BASE, PD_BASE, PDP_BASE,
                                         PML4_BASE, PWC_LAT, host_walk)
from repro_torch.core.stages.base import (Stage, StageResult, hash_h,
                                          l2_geom_of)
from repro_torch.core.stages.ptw import fill_walk_counters


def nested_translate(cfg, st, gpn, pressure, l2_bypass, enable, geom=None,
                     ven=None):
    """gPA-page -> hPA (virt.): nested TLB -> [Victima nested-TLB block] ->
    host walk.  Returns (st, cycles, host_walked, ntlb_hit, nvictima_hit),
    each ``[W]``; the state is updated in place.  `geom` is the L2
    cache's per-lane view, `ven` the per-lane Victima gate (None:
    static)."""
    en = as_mask(enable, gpn)
    zero = torch.zeros_like(en)
    if idle(en):
        return st, torch.zeros_like(gpn), zero, zero, zero
    ln = lane_ids(gpn)
    now = st.now
    hit_n, w_n, s_n = lookup(st.ntlb, gpn)
    st.ntlb.meta[ln, s_n, w_n] = torch.where(en & hit_n, now,
                                             st.ntlb.meta[ln, s_n, w_n])
    miss = en & ~hit_n
    cycles = en.int()  # 1-cycle nested TLB

    # Victima: probe the L2 cache for a nested TLB block
    if cfg.victima:
        vh, vw, vs = l2_lookup(st.hier.l2, gpn >> 3, BT_NTLB, geom)
        vhit = miss & vh
        if ven is not None:
            vhit = vhit & ven
        l2_touch(st.hier.l2, vs, vw, pressure, cfg.tlb_aware, vhit)
        cycles = cycles + cfg.lat.l2 * vhit.int()
    else:
        vhit = zero

    need_walk = miss & ~vhit
    _, wc, ndram, _ = host_walk(st.hier, gpn, pressure, cfg.tlb_aware,
                                cfg.lat, need_walk, geom)
    cycles = cycles + wc

    # host-page PTW-CP counters + nested-TLB-block insertion
    hidx = hash_h(gpn, cfg.n_pagesh)
    ptwcp.update_counters(st.pch, hidx, ndram >= 1, need_walk)
    if cfg.victima:
        pred = (ptwcp.predict_page(st.pch, hidx) if cfg.use_ptwcp
                else torch.ones_like(en))
        ins = need_walk & (pred | l2_bypass)
        if ven is not None:
            ins = ins & ven
        l2_retag_to_tlb(st.hier.l2, gpn >> 3, BT_NTLB, pressure,
                        cfg.tlb_aware, ins, geom)

    # refill the nested TLB; the evicted entry triggers a background walk
    _, ev_tag, ev_valid = insert_lru(st.ntlb, gpn, now, miss)
    if cfg.victima:
        eidx = hash_h(ev_tag, cfg.n_pagesh)
        epred = (ptwcp.predict_page(st.pch, eidx) if cfg.use_ptwcp
                 else torch.ones_like(en))
        bg = miss & ev_valid & (epred | l2_bypass)
        if ven is not None:
            bg = bg & ven
        _, _, bdram, _ = host_walk(st.hier, ev_tag, pressure, cfg.tlb_aware,
                                   cfg.lat, bg, geom)
        ptwcp.update_counters(st.pch, eidx, bdram >= 1, bg)
        l2_retag_to_tlb(st.hier.l2, ev_tag >> 3, BT_NTLB, pressure,
                        cfg.tlb_aware, bg, geom)

    return st, cycles, need_walk, en & hit_n, vhit


def guest_walk_2d(cfg, st, vpn, is2m, pressure, l2_bypass, enable,
                  geom=None, ven=None):
    """Nested-paging 2-D walk: every guest-PT access first resolves its own
    gPA->hPA via ``nested_translate``.  Returns (st, cycles, n_dram,
    n_host_walks, n_ntlb_hits, n_nvictima_hits)."""
    en = as_mask(enable, vpn)
    if idle(en):
        z = torch.zeros_like(vpn)
        return st, z, z, z, z, z
    vpn2 = vpn >> 9
    # unified 4-slot access plan (2M walks: PD is the leaf, depth 3)
    lines = [
        torch.where(is2m, PML4_BASE + ((vpn2 >> 18) >> 3),
                    PML4_BASE + ((vpn >> 27) >> 3)),
        torch.where(is2m, PDP_BASE + ((vpn2 >> 9) >> 3),
                    PDP_BASE + ((vpn >> 18) >> 3)),
        torch.where(is2m, PD_BASE + (vpn2 >> 3),
                    PD_BASE + ((vpn >> 9) >> 3)),
        LEAF4_BASE + (vpn >> 3),
    ]
    n_levels = torch.where(is2m, 3, 4)

    k_pml4 = torch.where(is2m, vpn2 >> 18, vpn >> 27)
    k_pdp = torch.where(is2m, vpn2 >> 9, vpn >> 18)
    k_pd = vpn >> 9
    pwcs = st.pwcs
    hit4, _, _ = lookup(pwcs.pml4, k_pml4)
    hit3, _, _ = lookup(pwcs.pdp, k_pdp)
    hit2, _, _ = lookup(pwcs.pd, k_pd)
    hit2 = hit2 & ~is2m
    start = torch.where(hit2, 3, torch.where(hit3, 2,
                                             torch.where(hit4, 1, 0)))
    start = torch.where(is2m, start.clamp_max(2), start)

    cycles = PWC_LAT * en.int()
    n_dram = torch.zeros_like(cycles)
    n_host = torch.zeros_like(cycles)
    n_nt_hit = torch.zeros_like(cycles)
    n_nv_hit = torch.zeros_like(cycles)
    for slot in range(4):
        slot_en = en & (start <= slot) & (n_levels > slot)
        # translate the guest-PT line's gPA page first
        st, ncyc, walked, nth, nvh = nested_translate(
            cfg, st, lines[slot] >> 6, pressure, l2_bypass, slot_en, geom,
            ven)
        n_host = n_host + (walked & slot_en).int()
        n_nt_hit = n_nt_hit + nth.int()
        n_nv_hit = n_nv_hit + nvh.int()
        _, c, d = access_pte(st.hier, lines[slot], pressure, cfg.tlb_aware,
                             cfg.lat, slot_en, geom=geom)
        cycles = cycles + ncyc + c
        n_dram = n_dram + d.int()

    insert_lru(pwcs.pml4, k_pml4, st.now, en & (start <= 0))
    insert_lru(pwcs.pdp, k_pdp, st.now, en & (start <= 1))
    insert_lru(pwcs.pd, k_pd, st.now, en & (start <= 2) & ~is2m)

    # finally translate the data page's own gPA (gpn = vpn, identity map)
    st, ncyc, walked, nth, nvh = nested_translate(
        cfg, st, vpn, pressure, l2_bypass, en, geom, ven)
    n_host = n_host + (walked & en).int()
    n_nt_hit = n_nt_hit + nth.int()
    n_nv_hit = n_nv_hit + nvh.int()
    return st, cycles + ncyc, n_dram, n_host, n_nt_hit, n_nv_hit


class NestedWalkStage(Stage):
    name = "ptw2d"

    def lookup(self, cfg, st, req, need):
        ven = None if req.dyn is None else req.dyn.victima_en
        st, wcyc, ndram, nhost, n_nt_hit, n_nv_hit = guest_walk_2d(
            cfg, st, req.vpn, req.is2m, req.pressure, req.l2_bypass, need,
            l2_geom_of(req.dyn), ven)
        info = {"walk_en": need, "ndram": ndram, "nhost": nhost,
                "n_nt_hit": n_nt_hit, "n_nv_hit": n_nv_hit}
        return st, StageResult(hit=need, cycles=wcyc, info=info)

    def fill(self, cfg, st, req, out):
        if cfg.victima:
            return st  # VictimaStage.fill owns the counter traffic
        return fill_walk_counters(cfg, st, req, out)
