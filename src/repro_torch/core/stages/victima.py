"""Stage: Victima — TLB blocks living in the L2 cache (paper §5); port of
``repro.core.stages.victima``.

Lookup probes the L2 cache for a typed TLB block covering the missing
page's 8-page region.  Fill implements the PTW-CP-gated install of the
demand walk's leaf PTEs plus the eviction-triggered background walk that
re-homes entries evicted from the L2 TLB (paper §5.2).

The counter traffic keeps the reference's fused two-slot form: slot 0 is
the demand page, slot 1 the background-walk page.  Both slots are read
before the walks and written after them, slot 0 first and then slot 1,
so when the two indices meet slot 1 wins — as XLA's in-order scatter
does (it can: indices are masked by ``n_pages - 1`` and footprints
exceed the table).  torch's ``index_put_`` leaves duplicates undefined,
hence two writes.

With ``Dyn`` overrides the L2 cache is each lane's view, and a lane whose
``victima_en`` is off (a radix member riding a Victima ladder) installs
no TLB block, walks nothing in the background and never hits; its slot 1
is redirected onto the demand index and carries slot 0's new value, so
its counters get the walker's plain update (``ptw.fill_walk_counters``).
"""
from __future__ import annotations

import torch

from repro_torch.core import ptwcp
from repro_torch.core.assoc import lane_ids
from repro_torch.core.caches import (BT_TLB2, BT_TLB4, l2_lookup,
                                     l2_retag_to_tlb, l2_touch)
from repro_torch.core.page_table import walk
from repro_torch.core.stages.base import (Stage, StageResult, dramc_of,
                                          l2_geom_of)


def _counter_write(pc: ptwcp.PageCounters, ln, idx, freq, cost) -> None:
    pc.freq[ln, idx] = freq.to(torch.uint8)
    pc.cost[ln, idx] = cost.to(torch.uint8)


class VictimaStage(Stage):
    name = "victima"

    def lookup(self, cfg, st, req, need):
        vkey = torch.where(req.is2m, req.vpn2 >> 3, req.vpn >> 3)
        vbt = torch.where(req.is2m, BT_TLB2, BT_TLB4).int()
        vh, vwy, sset = l2_lookup(st.hier.l2, vkey, vbt, l2_geom_of(req.dyn))
        vhit = need & vh
        if req.dyn is not None:
            vhit = vhit & req.dyn.victima_en
        l2_touch(st.hier.l2, sset, vwy, req.pressure, cfg.tlb_aware, vhit)
        return st, StageResult(hit=vhit, cycles=cfg.lat.l2 * vhit.int(),
                               info={"vkey": vkey, "vbt": vbt})

    def fill(self, cfg, st, req, out):
        walk_res = out["_walk"]
        walk_en = walk_res.info["walk_en"]
        ndram = walk_res.info["ndram"]
        miss2 = out["l2_tlb"].need
        ev_tag = out["l2_tlb"].info["ev_tag"]
        ev_valid = out["l2_tlb"].info["ev_valid"]
        vkey = out[self.name].info["vkey"]
        vbt = out[self.name].info["vbt"]
        is2m = req.is2m
        ln = lane_ids(req.vpn)
        geom = l2_geom_of(req.dyn)
        ven = None if req.dyn is None else req.dyn.victima_en

        ev_vpn = ev_tag >> 1
        ev2m = (ev_tag & 1).bool()
        bg_vpn4 = torch.where(ev2m, ev_vpn << 9, ev_vpn)

        d4 = (req.vpn & (cfg.n_pages4 - 1)).long()
        b4 = (bg_vpn4 & (cfg.n_pages4 - 1)).long()
        d2 = (req.vpn2 & (cfg.n_pages2 - 1)).long()
        b2 = (ev_vpn & (cfg.n_pages2 - 1)).long()
        if ven is not None:
            b4 = torch.where(ven, b4, d4)
            b2 = torch.where(ven, b2, d2)
        f4 = [st.pc4.freq[ln, i].int() for i in (d4, b4)]
        c4 = [st.pc4.cost[ln, i].int() for i in (d4, b4)]
        f2 = [st.pc2.freq[ln, i].int() for i in (d2, b2)]
        c2 = [st.pc2.cost[ln, i].int() for i in (d2, b2)]

        # demand prediction on post-walk counters (computed analytically)
        fpost = torch.where(is2m, f2[0], f4[0]) + walk_en.int()
        cpost = (torch.where(is2m, c2[0], c4[0])
                 + (walk_en & (ndram >= 1)).int())
        pred = ptwcp.predict(fpost.clamp_max(ptwcp.FREQ_MAX),
                             cpost.clamp_max(ptwcp.COST_MAX))
        if not cfg.use_ptwcp:
            pred = torch.ones_like(pred)
        ins = walk_en & (pred | req.l2_bypass)
        if ven is not None:
            ins = ins & ven
        l2_retag_to_tlb(st.hier.l2, vkey, vbt, req.pressure, cfg.tlb_aware,
                        ins, geom)

        # eviction-triggered background walk + TLB-block install (on the
        # state after the L2-TLB refill and the demand retag)
        fe = torch.where(ev2m, f2[1], f4[1])
        ce = torch.where(ev2m, c2[1], c4[1])
        epred = ptwcp.predict(fe, ce)
        if not cfg.use_ptwcp:
            epred = torch.ones_like(epred)
        bg = miss2 & ev_valid & (epred | req.l2_bypass)
        if ven is not None:
            bg = bg & ven
        _, _, _, bdram = walk(st.hier, st.pwcs, bg_vpn4, ev2m, req.now,
                              req.pressure, cfg.tlb_aware, cfg.lat, bg,
                              geom, dramc_of(cfg, req.dyn))
        ebt = torch.where(ev2m, BT_TLB2, BT_TLB4).int()
        l2_retag_to_tlb(st.hier.l2, ev_vpn >> 3, ebt, req.pressure,
                        cfg.tlb_aware, bg, geom)
        out[self.name].info["n_bg"] = bg.int()

        # fused saturating counter writeback: slot 0, then slot 1
        en4 = (walk_en & ~is2m, bg & ~ev2m)
        en2 = (walk_en & is2m, bg & ev2m)
        dr = (ndram >= 1, bdram >= 1)
        new = [((f4[k] + en4[k].int()).clamp_max(ptwcp.FREQ_MAX),
                (c4[k] + (en4[k] & dr[k]).int()).clamp_max(ptwcp.COST_MAX),
                (f2[k] + en2[k].int()).clamp_max(ptwcp.FREQ_MAX),
                (c2[k] + (en2[k] & dr[k]).int()).clamp_max(ptwcp.COST_MAX))
               for k in (0, 1)]
        if ven is not None:
            # gate off: slot 1 aliases slot 0 and carries its new value
            new[1] = tuple(torch.where(ven, a, b)
                           for a, b in zip(new[1], new[0]))
        for (i4, i2), (nf4, nc4, nf2, nc2) in zip(((d4, d2), (b4, b2)), new):
            _counter_write(st.pc4, ln, i4, nf4, nc4)
            _counter_write(st.pc2, ln, i2, nf2, nc2)
        return st
