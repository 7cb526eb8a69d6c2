"""Stage: optional hardware L3 TLB (probe latency swept in Fig. 8); port
of ``repro.core.stages.l3_tlb`` with the static geometry only."""
from __future__ import annotations

import torch

from repro_torch.core.assoc import insert_lru, lane_ids, lookup
from repro_torch.core.stages.base import Stage, StageResult


class L3TLBStage(Stage):
    name = "l3_tlb"

    def lookup(self, cfg, st, req, need):
        h3, w3, s3 = lookup(st.l3tlb, req.key2)
        l3hit = need & h3
        ln = lane_ids(req.key2)
        st.l3tlb.meta[ln, s3, w3] = torch.where(
            l3hit, req.now, st.l3tlb.meta[ln, s3, w3])
        # probe latency is paid by every access that reaches this level
        return st, StageResult(hit=l3hit, cycles=cfg.l3tlb_lat * need.int(),
                               info={})

    def fill(self, cfg, st, req, out):
        insert_lru(st.l3tlb, req.key2, req.now, out["_walk"].info["walk_en"])
        return st
