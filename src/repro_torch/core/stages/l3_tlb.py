"""Stage: optional hardware L3 TLB (probe latency swept in Fig. 8); port
of ``repro.core.stages.l3_tlb``.

With ``Dyn`` overrides a lane whose ``l3tlb_en`` is off neither pays the
probe latency nor touches the (never filled) structure, and the probe
latency is the lane's ``l3tlb_lat``.
"""
from __future__ import annotations

import torch

from repro_torch.core.assoc import insert_lru, lane_ids, lookup
from repro_torch.core.stages.base import Stage, StageResult


class L3TLBStage(Stage):
    name = "l3_tlb"

    def lookup(self, cfg, st, req, need):
        if req.dyn is None:
            lat, probe = cfg.l3tlb_lat, need
        else:
            lat, probe = req.dyn.l3tlb_lat, need & req.dyn.l3tlb_en
        h3, w3, s3 = lookup(st.l3tlb, req.key2)
        l3hit = probe & h3
        ln = lane_ids(req.key2)
        st.l3tlb.meta[ln, s3, w3] = torch.where(
            l3hit, req.now, st.l3tlb.meta[ln, s3, w3])
        # probe latency is paid by every access that reaches this level
        return st, StageResult(hit=l3hit, cycles=lat * probe.int(), info={})

    def fill(self, cfg, st, req, out):
        walk_en = out["_walk"].info["walk_en"]
        if req.dyn is not None:
            walk_en = walk_en & req.dyn.l3tlb_en
        insert_lru(st.l3tlb, req.key2, req.now, walk_en)
        return st
