"""Stage: demand page-table walk (native radix / I-SP 1-D shadow walk);
port of ``repro.core.stages.ptw``.

The terminal stage: everything still unresolved walks.  Fill maintains
the PTW-CP per-page counters for non-Victima systems (Victima folds its
counter updates into its own fused fill).
"""
from __future__ import annotations

import torch

from repro_torch.core import ptwcp
from repro_torch.core.page_table import walk
from repro_torch.core.stages.base import (Stage, StageResult, dramc_of,
                                          l2_geom_of)


def fill_walk_counters(cfg, st, req, out):
    """PTW-CP counter maintenance for the walked page (non-Victima)."""
    walk_en = out["_walk"].info["walk_en"]
    had_dram = out["_walk"].info["ndram"] >= 1
    ptwcp.update_counters(st.pc4, req.vpn & (cfg.n_pages4 - 1), had_dram,
                          walk_en & ~req.is2m)
    ptwcp.update_counters(st.pc2, req.vpn2 & (cfg.n_pages2 - 1), had_dram,
                          walk_en & req.is2m)
    return st


class RadixWalkStage(Stage):
    name = "ptw"

    def lookup(self, cfg, st, req, need):
        _, _, wcyc, ndram = walk(st.hier, st.pwcs, req.vpn, req.is2m,
                                 req.now, req.pressure, cfg.tlb_aware,
                                 cfg.lat, need, l2_geom_of(req.dyn),
                                 dramc_of(cfg, req.dyn))
        zero = torch.zeros_like(ndram)
        info = {"walk_en": need, "ndram": ndram, "nhost": zero,
                "n_nt_hit": zero, "n_nv_hit": zero}
        return st, StageResult(hit=need, cycles=wcyc, info=info)

    def fill(self, cfg, st, req, out):
        if cfg.victima:
            return st  # VictimaStage.fill owns the counter traffic
        return fill_walk_counters(cfg, st, req, out)
