"""Stage: Utopia — hybrid restrictive/flexible address mapping; port of
``repro.core.stages.utopia``.

Utopia backs translation-heavy pages with *RestSegs*: set-associative
memory segments whose mapping is restrictive, so a probe only has to
confirm the tag/permission metadata of the page's set.  Pages the
RestSegs do not hold live in the flexibly mapped FlexSeg and fall back to
the radix walker.  One RestSeg per page size (4K and 2M): a probe fetches
the set's tag line through the cache hierarchy (typed as a TLB block,
like POM-TLB lines) and a tag match resolves the translation with no
walk.  The migration engine in ``fill`` promotes costly-to-translate
pages into a RestSeg after their demand walk (the PTW-CP verdict), and a
set conflict demotes the LRU resident back to the FlexSeg.

With ``Dyn`` overrides ``utopia_en`` masks the probe's cache traffic, the
hit path and every migration of a lane, and ``restseg_ways`` gives each
lane its RestSeg associativity through way-masked views
(``assoc.lookup_dyn``/``insert_lru_dyn``; the set counts stay static).
"""
from __future__ import annotations

import torch

from repro_torch.core.assoc import (insert_lru, insert_lru_dyn, lane_ids,
                                    lookup, lookup_dyn)
from repro_torch.core.caches import BT_TLB4, access_pte
from repro_torch.core.page_table import RESTSEG2_BASE, RESTSEG4_BASE
from repro_torch.core.stages.base import (Stage, StageResult, l2_geom_of,
                                          ptwcp_walk_verdict)


def _touch(a, s, w, hit, now) -> None:
    ln = lane_ids(s)
    a.meta[ln, s, w] = torch.where(hit, now, a.meta[ln, s, w])


class RestSegStage(Stage):
    name = "restseg"

    def lookup(self, cfg, st, req, need):
        probe = need if req.dyn is None else need & req.dyn.utopia_en
        # one tag/permission line per set, fetched through the caches
        s4 = req.vpn & (cfg.restseg4_sets - 1)
        s2 = req.vpn2 & (cfg.restseg2_sets - 1)
        tag_line = torch.where(req.is2m, RESTSEG2_BASE + s2,
                               RESTSEG4_BASE + s4)
        _, cyc, _ = access_pte(st.hier, tag_line, req.pressure,
                               cfg.tlb_aware, cfg.lat, probe, bt=BT_TLB4,
                               geom=l2_geom_of(req.dyn))

        # probe both RestSegs; the access's page size selects the result
        if req.dyn is None:
            h4, w4, i4 = lookup(st.restseg4, req.vpn)
            h2, w2, i2 = lookup(st.restseg2, req.vpn2)
        else:
            ways = req.dyn.restseg_ways
            h4, w4, i4 = lookup_dyn(st.restseg4, req.vpn,
                                    cfg.restseg4_sets - 1, ways)
            h2, w2, i2 = lookup_dyn(st.restseg2, req.vpn2,
                                    cfg.restseg2_sets - 1, ways)
        hit4 = probe & ~req.is2m & h4
        hit2 = probe & req.is2m & h2
        # LRU touch keeps conflict demotions picking the coldest resident
        _touch(st.restseg4, i4, w4, hit4, req.now)
        _touch(st.restseg2, i2, w2, hit2, req.now)
        return st, StageResult(hit=hit4 | hit2, cycles=cyc,
                               info={"probed": probe})

    def fill(self, cfg, st, req, out):
        """Migration engine: promote costly-to-translate pages (PTW-CP
        verdict after their demand walk) into a RestSeg; a set conflict
        demotes the evicted resident back to the FlexSeg."""
        mig = ptwcp_walk_verdict(cfg, st, req, out["_walk"].info["walk_en"])
        if req.dyn is not None:
            mig = mig & req.dyn.utopia_en
        mig4 = mig & ~req.is2m
        mig2 = mig & req.is2m
        if req.dyn is None:
            _, _, conf4 = insert_lru(st.restseg4, req.vpn, req.now, mig4)
            _, _, conf2 = insert_lru(st.restseg2, req.vpn2, req.now, mig2)
        else:
            ways = req.dyn.restseg_ways
            _, _, conf4 = insert_lru_dyn(st.restseg4, req.vpn, req.now,
                                         cfg.restseg4_sets - 1, ways, mig4)
            _, _, conf2 = insert_lru_dyn(st.restseg2, req.vpn2, req.now,
                                         cfg.restseg2_sets - 1, ways, mig2)
        out[self.name].info["n_mig"] = (mig4 | mig2).int()
        out[self.name].info["n_conflict"] = (conf4 | conf2).int()
        return st
