"""Per-step folds over the pipeline's stage results: Stats accumulation
and the Table-2 per-page feature stream; port of
``repro.core.stages.fold``.

The hit counts of stages absent from a composition (and the RestSeg and
Revelator fields of systems without those stages) would add zero every
access and are left untouched; the walker's nested-walk counts are added
always (the radix walker reports zeros).  The f32 sums are added one
access at a time, in the reference's order: ``sum_tlb4_live`` passes
2^24 on long runs, where the order matters.
"""
from __future__ import annotations

import torch

from repro_torch.core.assoc import lane_ids
from repro_torch.core.stages.base import (MMUState, Stats,
                                          WALK_HIST_BUCKETS, hash_h)


def _bucket(cyc):
    return (cyc // 10).clamp_max(WALK_HIST_BUCKETS - 1).long()


def accum_stats(s: Stats, st: MMUState, out, walk_res, trans, past_l2,
                dcyc) -> Stats:
    """Fold one access into `s` (in place; returns it)."""
    miss2 = out["l2_tlb"].need
    walk_en = walk_res.info["walk_en"]
    wcyc = walk_res.cycles
    bucket = _bucket(wcyc)
    l2 = st.hier.l2
    s.n_access.add_(1)
    s.n_l1tlb_hit.add_(out["l1_tlb"].hit.int())
    s.n_l2tlb_hit.add_(out["l2_tlb"].hit.int())
    s.n_l2tlb_miss.add_(miss2.int())
    if "victima" in out:
        s.n_victima_hit.add_(out["victima"].hit.int())
        s.n_bg_ptw.add_(out["victima"].info["n_bg"])
    if "l3_tlb" in out:
        s.n_l3tlb_hit.add_(out["l3_tlb"].hit.int())
    if "pom" in out:
        s.n_pom_hit.add_(out["pom"].hit.int())
    s.n_demand_ptw.add_(walk_en.int())
    s.n_host_ptw.add_(walk_res.info["nhost"])
    s.n_ntlb_hit.add_(walk_res.info["n_nt_hit"])
    s.n_nvictima_hit.add_(walk_res.info["n_nv_hit"])
    s.sum_trans_cyc.add_(trans.float())
    s.sum_l2miss_cyc.add_((past_l2 * miss2.int()).float())
    s.sum_data_cyc.add_(dcyc.float())
    s.sum_walk_cyc.add_((wcyc * walk_en.int()).float())
    s.hist_walk[lane_ids(bucket), bucket] += walk_en.int()
    s.sum_tlb4_live.add_(l2.n_tlb4.float())
    s.sum_tlb2_live.add_(l2.n_tlb2.float())
    if "restseg" in out:
        rs = out["restseg"]
        probed = rs.info["probed"]
        s.n_restseg_hit.add_(rs.hit.int())
        s.n_restseg_miss.add_((probed & ~rs.hit).int())
        s.n_restseg_mig.add_(rs.info["n_mig"])
        s.n_restseg_conflict.add_(rs.info["n_conflict"])
        s.sum_restseg_cyc.add_(rs.cycles.float())
        b = _bucket(rs.cycles)
        s.hist_restseg[lane_ids(b), b] += probed.int()
    if "rev" in out:
        rv = out["rev"]
        vcyc = rv.info["verify_cyc"]
        s.n_rev_hit.add_(rv.info["correct"].int())
        s.n_rev_mispred.add_(rv.info["mispred"].int())
        s.n_rev_enroll.add_(rv.info["n_enroll"])
        s.sum_rev_verify_cyc.add_(vcyc.float())
        b = _bucket(vcyc)
        s.hist_rev_verify[lane_ids(b), b] += rv.hit.int()
    return s


def collect_feats(cfg, st: MMUState, req, out, walk_res) -> MMUState:
    """Table-2 per-page feature stream (hashed table; in place).

    The uint16 counters are added through int16 views of them (CPU torch
    does not add uint16), so ``+ 1`` wraps at 2^16 as the reference's
    does; ``walk_cyc`` is an f32 sum added one access at a time; ``is2m``
    is set, not or-ed.
    """
    ft = st.feats
    fi = hash_h(req.vpn_sz, cfg.n_feat).long()
    ln = lane_ids(fi)
    walk_en = walk_res.info["walk_en"]
    for x, inc in ((ft.n_access, torch.ones_like(walk_en)),
                   (ft.n_l1_miss, out["l1_tlb"].need),
                   (ft.n_l2_miss, out["l2_tlb"].need),
                   (ft.n_walk, walk_en)):
        x = x.view(torch.int16)
        x[ln, fi] = x[ln, fi] + inc.to(torch.int16)
    ft.walk_cyc[ln, fi] = ft.walk_cyc[ln, fi] + (
        walk_res.cycles * walk_en.int()).float()
    ft.is2m[ln, fi] = req.is2m.to(torch.uint8)
    return st
