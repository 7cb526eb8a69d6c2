"""Stage: split L1 D-TLBs (64-entry 4K + 32-entry 2M, LRU); port of
``repro.core.stages.l1_tlb``."""
from __future__ import annotations

import torch

from repro_torch.core.assoc import insert_lru, lane_ids, lookup
from repro_torch.core.stages.base import Stage, StageResult


class L1TLBStage(Stage):
    name = "l1_tlb"
    past_l2 = False

    def lookup(self, cfg, st, req, need):
        h4, w4, s4 = lookup(st.l1d4, req.vpn)
        h2, w2, s2 = lookup(st.l1d2, req.vpn2)
        hit1 = torch.where(req.is2m, h2, h4)
        ln = lane_ids(req.vpn)
        st.l1d4.meta[ln, s4, w4] = torch.where(
            h4 & ~req.is2m, req.now, st.l1d4.meta[ln, s4, w4])
        st.l1d2.meta[ln, s2, w2] = torch.where(
            h2 & req.is2m, req.now, st.l1d2.meta[ln, s2, w2])
        cycles = torch.full_like(req.vpn, cfg.l1tlb_lat)
        return st, StageResult(hit=hit1, cycles=cycles, info={})

    def fill(self, cfg, st, req, out):
        miss1 = out[self.name].need
        insert_lru(st.l1d4, req.vpn, req.now, miss1 & ~req.is2m)
        insert_lru(st.l1d2, req.vpn2, req.now, miss1 & req.is2m)
        return st
