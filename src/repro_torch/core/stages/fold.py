"""Per-step Stats fold over the pipeline's stage results; port of
``repro.core.stages.fold.accum_stats``.

The hit counts of stages absent from a composition, and the fields of
RestSeg and Revelator (not ported yet), would add zero every access and
are left untouched; the walker's nested-walk counts are added always
(the radix walker reports zeros).  The f32 sums are added one access at
a time, in the reference's order: ``sum_tlb4_live`` passes 2^24 on long
runs, where the order matters.
"""
from __future__ import annotations

from repro_torch.core.assoc import lane_ids
from repro_torch.core.stages.base import MMUState, Stats, WALK_HIST_BUCKETS


def accum_stats(s: Stats, st: MMUState, out, walk_res, trans, past_l2,
                dcyc) -> Stats:
    """Fold one access into `s` (in place; returns it)."""
    miss2 = out["l2_tlb"].need
    walk_en = walk_res.info["walk_en"]
    wcyc = walk_res.cycles
    bucket = (wcyc // 10).clamp_max(WALK_HIST_BUCKETS - 1).long()
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
    return s
