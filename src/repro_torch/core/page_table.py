"""Four-level radix page-table walk model (paper §2.2, Figs. 1 & 4);
lane-batched port of ``repro.core.page_table``.

Address map (64B-line ids, int32-safe):
  data lines            [0, 2^28)            line = va >> 6
  leaf PTE lines (4K)   LEAF4_BASE + vpn>>3  (8 PTEs / 64B line)
  PD lines              PD_BASE   + (vpn>>9)>>3   (also 2M leaf level)
  PDP lines             PDP_BASE  + (vpn>>18)>>3
  PML4 lines            PML4_BASE + (vpn>>27)>>3
  host PT lines (virt)  H*_BASE   + analogous, keyed by gpn
  POM-TLB lines         POM_BASE  + (vpn mod 64K)>>2

The walker is equipped with 3 split PWCs covering PML4/PDP/PD (2-cycle,
Table 3); a PWC hit at depth d skips all accesses above d.  4K walks touch
up to 4 lines, 2M walks up to 3 (the PD entry is the leaf).  The host
walk of nested paging (``host_walk``) has no PWCs: four PTE-line
accesses keyed by the guest-physical page.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.assoc import (Assoc, as_mask, idle, insert_lru, lookup,
                                    make)
from repro_torch.core.caches import Hier, L2Geom, Lat, access_pte

# line-id bases (disjoint regions; all < 2^30, int32-safe)
_B = 1 << 29
_W = 1 << 22
LEAF4_BASE = _B + 0 * _W
PD_BASE = _B + 1 * _W
PDP_BASE = _B + 2 * _W
PML4_BASE = _B + 3 * _W
HLEAF_BASE = _B + 4 * _W
HPD_BASE = _B + 5 * _W
HPDP_BASE = _B + 6 * _W
HPML4_BASE = _B + 7 * _W
POM_BASE = _B + 8 * _W
RESTSEG4_BASE = _B + 9 * _W   # Utopia 4K RestSeg tag/permission lines
RESTSEG2_BASE = _B + 10 * _W  # Utopia 2M RestSeg tag/permission lines

PWC_LAT = 2


class PWCs(NamedTuple):
    pml4: Assoc  # keyed vpn>>27
    pdp: Assoc   # keyed vpn>>18
    pd: Assoc    # keyed vpn>>9


def make_pwcs(sets=8, ways=4, lanes: int = 1, device="cpu") -> PWCs:
    return PWCs(pml4=make(sets, ways, lanes, device),
                pdp=make(sets, ways, lanes, device),
                pd=make(sets, ways, lanes, device))


def walk(h: Hier, pwcs: PWCs, vpn4k, is2m, now, pressure, tlb_aware: bool,
         lat: Lat, enable, geom: L2Geom | None = None):
    """One native radix walk.

    Returns (hier, pwcs, cycles, n_dram).  `cycles` includes the PWC
    probe.  The PWCs are probed on the state before the walk and `start`
    is fixed before any fill; all state updates are masked by `enable`.
    `geom` is the L2 cache's per-lane view (None = static geometry).
    """
    en = as_mask(enable, vpn4k)
    if idle(en):
        return h, pwcs, torch.zeros_like(vpn4k), torch.zeros_like(vpn4k)
    vpn2 = vpn4k >> 9
    # unified 4-slot access plan (2M walks: PD is the leaf, depth 3)
    lines = [
        torch.where(is2m, PML4_BASE + ((vpn2 >> 18) >> 3),
                    PML4_BASE + ((vpn4k >> 27) >> 3)),
        torch.where(is2m, PDP_BASE + ((vpn2 >> 9) >> 3),
                    PDP_BASE + ((vpn4k >> 18) >> 3)),
        torch.where(is2m, PD_BASE + (vpn2 >> 3),
                    PD_BASE + ((vpn4k >> 9) >> 3)),
        LEAF4_BASE + (vpn4k >> 3),
    ]
    n_levels = torch.where(is2m, 3, 4)

    # PWC probes: keys per level (2M pages use vpn2-derived upper keys)
    k_pml4 = torch.where(is2m, vpn2 >> 18, vpn4k >> 27)
    k_pdp = torch.where(is2m, vpn2 >> 9, vpn4k >> 18)
    k_pd = vpn4k >> 9  # only meaningful for 4K walks
    hit4, _, _ = lookup(pwcs.pml4, k_pml4)
    hit3, _, _ = lookup(pwcs.pdp, k_pdp)
    hit2, _, _ = lookup(pwcs.pd, k_pd)
    hit2 = hit2 & ~is2m  # PD entries of 2M walks are leaves, not cached

    # deepest covered level → first slot that must be fetched
    start = torch.where(hit2, 3, torch.where(hit3, 2,
                                             torch.where(hit4, 1, 0)))
    start = torch.where(is2m, start.clamp_max(2), start)

    cycles = torch.where(en, PWC_LAT, 0).int()
    n_dram = torch.zeros_like(cycles)
    for slot in range(4):
        slot_en = en & (start <= slot) & (n_levels > slot)
        h, c, d = access_pte(h, lines[slot], pressure, tlb_aware, lat,
                             slot_en, geom=geom)
        cycles = cycles + c
        n_dram = n_dram + d.int()

    # fill PWCs for the upper levels just walked
    insert_lru(pwcs.pml4, k_pml4, now, en & (start <= 0))
    insert_lru(pwcs.pdp, k_pdp, now, en & (start <= 1))
    insert_lru(pwcs.pd, k_pd, now, en & (start <= 2) & ~is2m)
    return h, pwcs, cycles, n_dram


def _host_lines(gpn):
    return (
        HPML4_BASE + ((gpn >> 27) >> 3),
        HPDP_BASE + ((gpn >> 18) >> 3),
        HPD_BASE + ((gpn >> 9) >> 3),
        HLEAF_BASE + (gpn >> 3),
    )


def host_walk(h: Hier, gpn, pressure, tlb_aware: bool, lat: Lat, enable,
              geom: L2Geom | None = None):
    """Host-PT walk (virt., no PWCs -- paper Fig. 3 gives the host walker a
    nested TLB instead): 4 sequential PTE-line accesses through the
    caches.  Returns (hier, cycles, n_dram, leaf_line)."""
    en = as_mask(enable, gpn)
    lines = _host_lines(gpn)
    cycles = torch.zeros_like(gpn)
    n_dram = torch.zeros_like(gpn)
    if idle(en):
        return h, cycles, n_dram, lines[3]
    for ln in lines:
        h, c, d = access_pte(h, ln, pressure, tlb_aware, lat, en, geom=geom)
        cycles = cycles + c
        n_dram = n_dram + d.int()
    return h, cycles, n_dram, lines[3]
