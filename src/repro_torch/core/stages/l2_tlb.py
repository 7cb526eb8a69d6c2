"""Stage: unified L2 TLB (size-tagged keys, LRU); port of
``repro.core.stages.l2_tlb`` with the static geometry only.

The refill publishes the evicted entry into its ``info``: Victima's
eviction-triggered background walk consumes it.
"""
from __future__ import annotations

import torch

from repro_torch.core.assoc import insert_lru, lane_ids, lookup
from repro_torch.core.stages.base import Stage, StageResult


class L2TLBStage(Stage):
    name = "l2_tlb"
    past_l2 = False

    def lookup(self, cfg, st, req, need):
        ht, wt, stt = lookup(st.l2tlb, req.key2)
        hit = need & ht
        ln = lane_ids(req.key2)
        st.l2tlb.meta[ln, stt, wt] = torch.where(
            hit, req.now, st.l2tlb.meta[ln, stt, wt])
        cycles = cfg.l2tlb_lat * need.int()
        return st, StageResult(hit=hit, cycles=cycles, info={})

    def fill(self, cfg, st, req, out):
        miss2 = out[self.name].need
        _, ev_tag, ev_valid = insert_lru(st.l2tlb, req.key2, req.now, miss2)
        out[self.name].info["ev_tag"] = ev_tag
        out[self.name].info["ev_valid"] = ev_valid
        return st
