"""Stage: Revelator — hash-based speculative address translation; port of
``repro.core.stages.revelator`` for native configurations.

On an L2-TLB miss the core hashes the size-tagged page id to a lossy
signature and probes a small signature table at a fixed latency
(``rev_lat``).  A signature hit resolves the translation (a correct
prediction and a misprediction alike: the verification walk yields the
right translation), so the later stages and the demand walker are
skipped.  The verification walk runs in ``lookup`` with real cache and
page-table traffic; only a misprediction (the enrolled page differs from
this one: an alias) puts its cycles on the critical path, and it repairs
the aliased entry in place.  Enrollment in ``fill`` is PTW-CP-guided,
after the walker's or Victima's counter update.  With ``Dyn`` overrides
a lane whose ``rev_en`` is off probes nothing, walks nothing and enrolls
nothing, and the verification walk sees the lane's L2-cache view.
"""
from __future__ import annotations

import torch

from repro_torch.core.assoc import (first_true, lane_ids, lru_victim,
                                    set_index)
from repro_torch.core.page_table import walk
from repro_torch.core.stages.base import (RevTable, Stage, StageResult,
                                          l2_geom_of, ptwcp_walk_verdict)

# the signature's multiplier; the int32 product wraps, as in the
# reference (torch's int32 ``*`` does on the CPU and on CUDA)
REV_MUL = -1640531535


def rev_sig(key2: torch.Tensor, bits: int) -> torch.Tensor:
    """Lossy multiplicative-hash signature of a size-tagged page id."""
    return (key2 * REV_MUL) & ((1 << bits) - 1)


def _rev_insert(rev: RevTable, sig, key2, now, enable) -> RevTable:
    """``insert_lru`` plus the shadow enrolled-page write (same way), in
    place."""
    tab = rev.tab
    s = set_index(sig, tab.n_sets)
    w = lru_victim(tab, s)
    ln = lane_ids(s)
    tab.tags[ln, s, w] = torch.where(enable, sig, tab.tags[ln, s, w])
    tab.valid[ln, s, w] = tab.valid[ln, s, w] | enable
    tab.meta[ln, s, w] = torch.where(enable, now, tab.meta[ln, s, w])
    rev.vpn[ln, s, w] = torch.where(enable, key2, rev.vpn[ln, s, w])
    return rev


class RevelatorStage(Stage):
    name = "rev"

    def lookup(self, cfg, st, req, need):
        sig = rev_sig(req.key2, cfg.rev_sig_bits)
        tab = st.rev.tab
        s = set_index(sig, tab.n_sets)
        ln = lane_ids(s)
        row_hits = tab.valid[ln, s] & (tab.tags[ln, s] == sig[:, None])
        # the lowest matching way: enrollment can leave a signature twice
        w = first_true(row_hits)
        probe = need if req.dyn is None else need & req.dyn.rev_en
        sig_hit = probe & row_hits.any(1)
        # a lossy-signature hit whose enrolled page differs is the
        # misprediction: the speculative frame belonged to the alias
        correct = sig_hit & (st.rev.vpn[ln, s, w] == req.key2)
        mispred = sig_hit & ~correct

        # LRU touch and in-place repair (a no-op on correct hits)
        tab.meta[ln, s, w] = torch.where(sig_hit, req.now, tab.meta[ln, s, w])
        st.rev.vpn[ln, s, w] = torch.where(sig_hit, req.key2,
                                           st.rev.vpn[ln, s, w])

        # the verification walk: real page-table and cache traffic, off
        # the critical path unless the prediction was wrong
        _, _, vcyc, _ = walk(st.hier, st.pwcs, req.vpn, req.is2m, req.now,
                             req.pressure, cfg.tlb_aware, cfg.lat, sig_hit,
                             l2_geom_of(req.dyn))
        vcyc = vcyc * sig_hit.int()
        cycles = (cfg.rev_lat + vcyc * mispred.int()) * sig_hit.int()
        return st, StageResult(hit=sig_hit, cycles=cycles,
                               info={"correct": correct, "mispred": mispred,
                                     "verify_cyc": vcyc})

    def fill(self, cfg, st, req, out):
        """PTW-CP-guided enrollment: after a demand walk, the freshly
        trained counters (this fill runs after the walker's or Victima's
        counter updates, see ``stages.fill_order``) decide whether the
        walked page is costly enough to enroll."""
        enroll = ptwcp_walk_verdict(cfg, st, req,
                                    out["_walk"].info["walk_en"])
        if req.dyn is not None:
            enroll = enroll & req.dyn.rev_en
        sig = rev_sig(req.key2, cfg.rev_sig_bits)
        _rev_insert(st.rev, sig, req.key2, req.now, enroll)
        out[self.name].info["n_enroll"] = enroll.int()
        return st
