"""Derived metrics over simulator Stats (the paper's reported quantities).

The port's own copy of ``repro.core.metrics`` (numpy only), so both
packages report through the same arithmetic.
"""
from __future__ import annotations

import numpy as np

KB = 1 << 10
MB = 1 << 20


def l2tlb_mpki(stats, ipa: float) -> float:
    instrs = float(stats.n_access) * ipa
    return float(stats.n_l2tlb_miss) * 1000.0 / max(instrs, 1.0)


def avg_walk_cycles(stats) -> float:
    return float(stats.sum_walk_cyc) / max(float(stats.n_demand_ptw), 1.0)


def avg_l2tlb_miss_latency(stats) -> float:
    """Cycles past the L2 TLB probe, averaged over L2-TLB misses
    (paper Figs. 9/22/29)."""
    return float(stats.sum_l2miss_cyc) / max(float(stats.n_l2tlb_miss), 1.0)


def reduction(base_n: float, new_n: float) -> float:
    """1 - new/base with a sane degenerate case: a baseline of zero means
    there is nothing to reduce, so the reduction is 0.0 — NOT the large
    negative number that ``1 - new/max(base, 1)`` used to produce.

    (The ``max(x, 1.0)`` guards in the *average* metrics above/below are
    safe as-is: whenever their denominator is 0 the numerator provably
    is too — no walks means no walk cycles — so they yield 0.0.)
    """
    b = float(base_n)
    return 0.0 if b == 0.0 else 1.0 - float(new_n) / b


def rate(num: float, den: float) -> float:
    """num/den with the same degenerate contract as ``reduction``: a
    denominator of zero means the event never happened, so the rate is
    0.0 — NOT ``num/max(den, 1)``, which silently reports a wrong
    nonzero value whenever ``num > 0 and den == 0`` can occur (and which
    hides bugs where it can't).  Every per-core metric routes through
    here so an idle lane in a multiprogrammed mix reports exactly 0.0.
    """
    d = float(den)
    return 0.0 if d == 0.0 else float(num) / d


def ptw_reduction(base_stats, new_stats) -> float:
    return reduction(base_stats.n_demand_ptw, new_stats.n_demand_ptw)


def per_core_ptw_reduction(base_stats, new_stats) -> list:
    """Per-core-lane PTW reductions for multicore results (each result is
    a tuple of per-core Stats).  Idle lanes — zero baseline walks — come
    out as 0.0 through ``reduction``'s base==0 guard rather than a
    nonsense negative number."""
    return [ptw_reduction(b, n) for b, n in zip(base_stats, new_stats)]


def mean_ptw_reduction(base_stats, new_stats) -> float:
    """Mean of the per-core PTW reductions (the multicore headline)."""
    per = per_core_ptw_reduction(base_stats, new_stats)
    return rate(sum(per), len(per))


def l3_translation_share(extras: dict) -> float:
    """Fraction of shared-L3 cache accesses that were translation
    traffic (TLB-block or PTE lines), from a shared-tier extras dict.
    Zero L3 accesses — e.g. an idle core lane — reports 0.0."""
    return rate(extras.get("l3_trans", 0), extras.get("l3_access", 0))


def dramc_hit_rate(extras: dict) -> float:
    """Die-stacked DRAM-cache hit rate from a shared-tier extras dict;
    0.0 when the DRAM cache is compiled out (no accesses)."""
    return rate(extras.get("dramc_hit", 0), extras.get("dramc_access", 0))


def host_ptw_reduction(base_stats, new_stats) -> float:
    """Virtualized runs: reduction in demand *host* walks (Fig. 28)."""
    return reduction(base_stats.n_host_ptw, new_stats.n_host_ptw)


def stage_hit_rates(stats) -> dict:
    """Fraction of accesses resolved at each translation level (the
    per-stage decomposition behind the MPKI/latency headlines)."""
    n = max(float(stats.n_access), 1.0)
    return {
        "l1_tlb": float(stats.n_l1tlb_hit) / n,
        "l2_tlb": float(stats.n_l2tlb_hit) / n,
        "victima": float(stats.n_victima_hit) / n,
        "l3_tlb": float(stats.n_l3tlb_hit) / n,
        "pom": float(stats.n_pom_hit) / n,
    }


def bg_walk_fraction(stats) -> float:
    """Fraction of all PTWs issued in the background (Victima's
    TLB-block promotion walks — off the critical path)."""
    total = float(stats.n_demand_ptw) + float(stats.n_bg_ptw)
    return float(stats.n_bg_ptw) / max(total, 1.0)


def nested_hit_rates(stats) -> dict:
    """Virtualized walks: per-access rates of nested-TLB and
    nested-Victima-block hits inside the 2D walker, next to the demand
    host-walk rate they displace."""
    n = max(float(stats.n_access), 1.0)
    return {
        "ntlb": float(stats.n_ntlb_hit) / n,
        "nvictima": float(stats.n_nvictima_hit) / n,
        "host_ptw": float(stats.n_host_ptw) / n,
    }


def rev_enroll_rate(stats) -> float:
    """Revelator enrollments per demand walk (signature-table ingest
    pressure: ~1.0 means every walk trains the table)."""
    return float(stats.n_rev_enroll) / max(float(stats.n_demand_ptw), 1.0)


def restseg_hit_rate(stats) -> float:
    """Fraction of RestSeg probes resolved without any FlexSeg walk
    (Utopia: probes happen on L2-TLB / Victima / L3 / POM misses)."""
    probes = float(stats.n_restseg_hit) + float(stats.n_restseg_miss)
    return float(stats.n_restseg_hit) / max(probes, 1.0)


def restseg_conflict_rate(stats) -> float:
    """Fraction of RestSeg migrations that demoted a resident page back
    to the FlexSeg (set-conflict pressure on the restrictive mapping)."""
    return float(stats.n_restseg_conflict) / max(
        float(stats.n_restseg_mig), 1.0)


def avg_restseg_probe_cycles(stats) -> float:
    probes = float(stats.n_restseg_hit) + float(stats.n_restseg_miss)
    return float(stats.sum_restseg_cyc) / max(probes, 1.0)


def rev_coverage(stats) -> float:
    """Fraction of L2-TLB misses the Revelator signature table resolved
    speculatively (correct predictions AND mispredictions — both skip
    the demand walker; a mispredict just pays the overlapped walk)."""
    resolved = float(stats.n_rev_hit) + float(stats.n_rev_mispred)
    return resolved / max(float(stats.n_l2tlb_miss), 1.0)


def rev_accuracy(stats) -> float:
    """Fraction of speculative translations that verified correct."""
    resolved = float(stats.n_rev_hit) + float(stats.n_rev_mispred)
    return float(stats.n_rev_hit) / max(resolved, 1.0)


def avg_rev_verify_cycles(stats) -> float:
    """Average verification-walk latency per speculative resolution
    (overlapped: critical-path only on mispredict)."""
    resolved = float(stats.n_rev_hit) + float(stats.n_rev_mispred)
    return float(stats.sum_rev_verify_cyc) / max(resolved, 1.0)


def translation_reach_mb(stats) -> float:
    """Average extra reach from TLB blocks resident in the L2 cache,
    *assuming 4KB pages* exactly as the paper's Fig. 23 does (8×4KB=32KB
    per block).  ``true_reach_mb`` weighs 2M blocks by real coverage."""
    n = max(float(stats.n_access), 1.0)
    blocks = (float(stats.sum_tlb4_live) + float(stats.sum_tlb2_live)) / n
    return blocks * 8 * 4 * KB / MB


def true_reach_mb(stats) -> float:
    n = max(float(stats.n_access), 1.0)
    avg4 = float(stats.sum_tlb4_live) / n
    avg2 = float(stats.sum_tlb2_live) / n
    return (avg4 * 8 * 4 * KB + avg2 * 8 * 2 * MB) / MB


def baseline_l2tlb_reach_mb(entries: int = 1536) -> float:
    return entries * 4 * KB / MB  # paper Fig. 23 assumes 4K pages


def reuse_distribution(hist: np.ndarray) -> np.ndarray:
    """Normalize a REUSE_BUCKETS histogram to fractions."""
    h = np.asarray(hist, dtype=np.float64)
    return h / max(h.sum(), 1.0)


def zero_reuse_fraction(hist: np.ndarray) -> float:
    return float(reuse_distribution(hist)[0])


def high_reuse_fraction(hist: np.ndarray, thresh: int = 21) -> float:
    """Fraction of blocks with reuse > 20 (paper Fig. 24 'high reuse')."""
    return float(reuse_distribution(hist)[thresh:].sum())


def _hist_fractions(hist) -> list:
    """(bucket_start_cycles, fraction) pairs on the 10-cycle grid."""
    h = np.asarray(hist, dtype=np.float64)
    frac = h / max(h.sum(), 1.0)
    return [(i * 10, f) for i, f in enumerate(frac)]


def walk_latency_histogram(stats):
    """(bucket_start_cycles, fraction) pairs for the Fig. 4 distribution."""
    return _hist_fractions(stats.hist_walk)


def restseg_probe_histogram(stats):
    """RestSeg tag-probe latency distribution (same grid as Fig. 4)."""
    return _hist_fractions(stats.hist_restseg)


def rev_verify_histogram(stats):
    """Revelator verification-walk latency distribution (overlapped;
    critical-path only on mispredict)."""
    return _hist_fractions(stats.hist_rev_verify)
