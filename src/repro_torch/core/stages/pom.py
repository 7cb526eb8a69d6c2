"""Stage: POM-TLB -- software-managed L3 TLB resident in memory; port of
``repro.core.stages.pom``.

Entries are fetched through the cache hierarchy (typed as TLB blocks so
the TLB-aware SRRIP prioritizes them, per Table 3); hit/miss bookkeeping
is tracked by a shadow associative structure.  Fill learns both the
demand-walked entry and the L2 TLB's evicted entry, in that order.
With ``Dyn`` overrides a lane whose ``pom_en`` is off fetches no POM
line through the caches, probes nothing and learns nothing.
"""
from __future__ import annotations

import torch

from repro_torch.core.assoc import insert_lru, lane_ids, lookup
from repro_torch.core.caches import BT_TLB4, access_pte
from repro_torch.core.page_table import POM_BASE
from repro_torch.core.stages.base import (Stage, StageResult, dramc_of,
                                          l2_geom_of)


class POMStage(Stage):
    name = "pom"

    def lookup(self, cfg, st, req, need):
        probe = need if req.dyn is None else need & req.dyn.pom_en
        pom_line = POM_BASE + (
            (req.key2 & ((cfg.pom_sets * cfg.pom_ways) - 1)) >> 2)
        _, pc_cyc, _ = access_pte(st.hier, pom_line, req.pressure,
                                  cfg.tlb_aware, cfg.lat, probe, bt=BT_TLB4,
                                  geom=l2_geom_of(req.dyn),
                                  dramc=dramc_of(cfg, req.dyn))
        hp, wp, sp = lookup(st.pom, req.key2)
        pomhit = probe & hp
        ln = lane_ids(req.key2)
        st.pom.meta[ln, sp, wp] = torch.where(pomhit, req.now,
                                              st.pom.meta[ln, sp, wp])
        return st, StageResult(hit=pomhit, cycles=pc_cyc, info={})

    def fill(self, cfg, st, req, out):
        walk_en = out["_walk"].info["walk_en"]
        l2 = out["l2_tlb"]
        ev_valid = l2.info["ev_valid"]
        if req.dyn is not None:
            walk_en = walk_en & req.dyn.pom_en
            ev_valid = ev_valid & req.dyn.pom_en
        insert_lru(st.pom, req.key2, req.now, walk_en)
        insert_lru(st.pom, l2.info["ev_tag"], req.now, l2.need & ev_valid)
        return st
