"""Analytical end-to-end timing model (paper §3 calibration).

The port's own copy of ``repro.core.timing`` (pure Python).

The trace-driven MMU model yields exact per-component cycle sums; end-to-
end execution time is reconstructed with a simple OoO model:

    cycles = instrs·CPI_exec                      (issue-limited base)
           + Σ translation_cycles                 (serial: gates the access)
           + (1-OVERLAP)·Σ (data_cycles - L1_hit) (MLP hides a fraction)

Constants are calibrated once so the *baseline* Radix system reproduces
the paper's §3 observation that ≈30% of execution cycles are spent on
address translation at L2-TLB MPKI ≈ 39; they are then frozen across every
evaluated system, so speedups are apples-to-apples.
"""
from __future__ import annotations

CPI_EXEC = 0.55      # 4-wide OoO core, issue-limited CPI
OVERLAP = 0.55       # fraction of data-miss latency hidden by MLP/OoO
L1_HIT_CYCLES = 4.0


def total_cycles(stats, ipa: float) -> float:
    n = float(stats.n_access)
    instrs = n * ipa
    trans = float(stats.sum_trans_cyc)
    data = float(stats.sum_data_cyc)
    data_stall = max(data - L1_HIT_CYCLES * n, 0.0) * (1.0 - OVERLAP)
    return instrs * CPI_EXEC + trans + data_stall


def translation_fraction(stats, ipa: float) -> float:
    return float(stats.sum_trans_cyc) / max(total_cycles(stats, ipa), 1.0)


def speedup(base_stats, new_stats, ipa: float) -> float:
    return total_cycles(base_stats, ipa) / max(total_cycles(new_stats, ipa), 1.0)


def mix_total_cycles(stats_list, ipa_list) -> float:
    """End-to-end cycles for a multiprogrammed mix: the cores run
    concurrently, so the co-schedule finishes when the slowest lane
    does (max over per-core analytical cycles)."""
    return max(total_cycles(s, ipa)
               for s, ipa in zip(stats_list, ipa_list))


def weighted_speedup(base_list, new_list, ipa_list) -> float:
    """Multiprogrammed speedup as the mean of per-core speedups (each
    lane vs the same lane under the baseline scheme) — the standard
    weighted-speedup metric for co-scheduled workloads."""
    per = [speedup(b, n, ipa)
           for b, n, ipa in zip(base_list, new_list, ipa_list)]
    return sum(per) / max(len(per), 1)
