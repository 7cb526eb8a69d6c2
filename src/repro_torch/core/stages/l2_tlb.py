"""Stage: unified L2 TLB (size-tagged keys, LRU); port of
``repro.core.stages.l2_tlb``.

With ``Dyn`` overrides on the request the probe and refill run against
each lane's dynamically sized view of the allocated structure
(``assoc.lookup_dyn``), and the probe latency is the lane's.  The refill
publishes the evicted entry into its ``info``: POM-TLB learning and
Victima's eviction-triggered background walk consume it.
"""
from __future__ import annotations

import torch

from repro_torch.core.assoc import (insert_lru, insert_lru_dyn, lane_ids,
                                    lookup, lookup_dyn)
from repro_torch.core.stages.base import Stage, StageResult


class L2TLBStage(Stage):
    name = "l2_tlb"
    past_l2 = False

    def lookup(self, cfg, st, req, need):
        if req.dyn is None:
            ht, wt, stt = lookup(st.l2tlb, req.key2)
            lat = cfg.l2tlb_lat
        else:
            ht, wt, stt = lookup_dyn(st.l2tlb, req.key2,
                                     req.dyn.l2tlb_set_mask,
                                     req.dyn.l2tlb_ways)
            lat = req.dyn.l2tlb_lat
        hit = need & ht
        ln = lane_ids(req.key2)
        st.l2tlb.meta[ln, stt, wt] = torch.where(
            hit, req.now, st.l2tlb.meta[ln, stt, wt])
        cycles = lat * need.int()
        return st, StageResult(hit=hit, cycles=cycles, info={})

    def fill(self, cfg, st, req, out):
        miss2 = out[self.name].need
        if req.dyn is None:
            _, ev_tag, ev_valid = insert_lru(st.l2tlb, req.key2, req.now,
                                             miss2)
        else:
            _, ev_tag, ev_valid = insert_lru_dyn(
                st.l2tlb, req.key2, req.now, req.dyn.l2tlb_set_mask,
                req.dyn.l2tlb_ways, miss2)
        out[self.name].info["ev_tag"] = ev_tag
        out[self.name].info["ev_valid"] = ev_valid
        return st
