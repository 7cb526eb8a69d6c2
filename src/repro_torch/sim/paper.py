"""One function per paper table/figure (§9 + §3 motivation); the port of
``benchmarks/paper.py``'s figure reductions over
``repro_torch.sim.runner.run_batch``.

Every function returns a list of rows ``(name, us_per_call, derived)``:
``us_per_call`` is the simulation wall per traced access of the fetch
that gave the row's system, ``derived`` the headline metric with the
paper's value beside it.  Names and ``derived`` strings are the
reference's, letter for letter.

Each function takes keyword arguments only: ``workloads`` (default all
11), ``n`` (accesses a workload, default 150,000), ``seed``, ``device``
(the card unless the caller names another) and ``fetch``, the function
``fetch(system) -> {workload: (stats, extras, spec)}`` that the bodies go
through (default: ``run_batch`` with those settings and its disk
cache).  As in the reference, a system that belongs to a ladder
(``_LADDER_OF``) first has its whole ladder filled through
``run_ladder``, and the timed ``run_batch`` then reads it from the
cache; a caller's own ``fetch`` bypasses both.  ``table2_ptwcp`` also
takes ``inits``, the MLPs' initial layers (``ptwcp_nn.run_study``).

``multicore_scaling`` runs each multicore system on one mix
(``MC_MIX``, ``REPRO_SIM_MIX`` as in the reference; its first component
alone at one core) through ``run_batch`` of that one workload, after the
system's ladder is filled through ``run_ladder`` (``Run.mc_sys``).
"""
from __future__ import annotations

import functools
import os
import time

import numpy as np

from repro_torch.core import metrics, ptwcp_nn, timing
from repro_torch.sim import runner, systems, trace_gen

N = 150_000

# the ladder each ladder member's fetch fills first (systems.LADDERS)
_LADDER_OF = {s: lad for lad, members in systems.LADDERS.items()
              for s in members}


class Run:
    """The settings a figure runs with, and its system fetch."""

    def __init__(self, workloads=None, n: int = N, seed: int = 0,
                 device=None, fetch=None):
        self.wls = list(workloads or trace_gen.all_workloads())
        bad = sorted(set(self.wls) - set(trace_gen.WORKLOADS))
        if bad:
            raise ValueError(f"unknown workload(s) {', '.join(bad)}; known: "
                             f"{', '.join(trace_gen.WORKLOADS)}")
        self.n, self.seed, self.device = n, seed, device
        self.ladders = fetch is None
        self.fetch = fetch or (lambda name: runner.run_batch(
            name, workloads=self.wls, n=self.n, seed=self.seed,
            device=self.device))

    def sys(self, name):
        """(results of `name`, wall microseconds per traced access).  The
        default fetch fills `name`'s ladder first (untimed, as in the
        reference); the time is then the cached fetch's."""
        if self.ladders and name in _LADDER_OF:
            runner.run_ladder(_LADDER_OF[name], workloads=self.wls,
                              n=self.n, seed=self.seed, device=self.device)
        t0 = time.time()
        out = self.fetch(name)
        us = (time.time() - t0) * 1e6 / (self.n * len(self.wls))
        return out, us

    def mc_sys(self, name, workload):
        """(result of multicore system `name` on mix `workload`, wall
        microseconds per traced access), its ladder filled first
        (untimed)."""
        if name in _LADDER_OF:
            runner.run_ladder(_LADDER_OF[name], workloads=[workload],
                              n=self.n, seed=self.seed, device=self.device)
        t0 = time.time()
        out = runner.run_batch(name, workloads=[workload], n=self.n,
                               seed=self.seed, device=self.device)[workload]
        return out, (time.time() - t0) * 1e6 / self.n

    def gmean_speedup(self, base, new):
        sp = []
        for w in self.wls:
            b, _, spec = base[w]
            n, _, _ = new[w]
            sp.append(timing.speedup(b, n, spec.ipa))
        return float(np.exp(np.mean(np.log(sp))))

    def avg(self, fn, out):
        return float(np.mean([fn(out[w][0], out[w][2]) for w in self.wls]))

    def mean(self, fn):
        return float(np.mean([fn(w) for w in self.wls]))


def _figure(fn):
    """A figure body ``fn(run, **extra)`` as a function of keywords."""
    @functools.wraps(fn)
    def figure(*, workloads=None, n: int = N, seed: int = 0, device=None,
               fetch=None, **extra):
        return fn(Run(workloads, n, seed, device, fetch), **extra)
    return figure


# ---------------------------------------------------------------- §3


@_figure
def fig4_ptw_latency(r):
    out, us = r.sys("radix")
    walks = r.avg(lambda s, sp: metrics.avg_walk_cycles(s), out)
    return [("fig4_avg_ptw_latency_cycles", us,
             f"{walks:.0f} (paper 137)")]


@_figure
def fig5_fig6_fig7_l2tlb_scaling(r):
    rows = []
    base, us = r.sys("radix")
    mpki0 = r.avg(lambda s, sp: metrics.l2tlb_mpki(s, sp.ipa), base)
    rows.append(("fig5_mpki_1.5K", us, f"{mpki0:.1f} (paper 39)"))
    for tag, label in [("l2tlb_3k", "3K"), ("l2tlb_8k", "8K"),
                       ("l2tlb_16k", "16K"), ("l2tlb_32k", "32K"),
                       ("l2tlb_64k", "64K"), ("l2tlb_128k", "128K")]:
        out, us = r.sys(tag)
        mpki = r.avg(lambda s, sp: metrics.l2tlb_mpki(s, sp.ipa), out)
        sp = r.gmean_speedup(base, out)
        rows.append((f"fig5_mpki_{label}", us, f"{mpki:.1f}"))
        rows.append((f"fig6_speedup_opt_{label}", us,
                     f"{(sp-1)*100:.1f}% (paper 64K: +4.0%)"))
    for tag, label in [("l2tlb_8k_real", "8K@17c"),
                       ("l2tlb_16k_real", "16K@23c"),
                       ("l2tlb_32k_real", "32K@30c"),
                       ("l2tlb_64k_real", "64K@39c")]:
        out, us = r.sys(tag)
        sp = r.gmean_speedup(base, out)
        rows.append((f"fig7_speedup_real_{label}", us,
                     f"{(sp-1)*100:.1f}% (paper 64K: +0.8%)"))
    return rows


@_figure
def fig8_l3tlb(r):
    base, _ = r.sys("radix")
    rows = []
    for tag, label in [("l3tlb_64k_15", "15c"), ("l3tlb_64k_24", "24c"),
                       ("l3tlb_64k_39", "39c")]:
        out, us = r.sys(tag)
        sp = r.gmean_speedup(base, out)
        rows.append((f"fig8_l3tlb_{label}", us,
                     f"{(sp-1)*100:.1f}% (paper 15c: +2.9%)"))
    return rows


@_figure
def fig9_stlb_miss_latency(r):
    rows = []
    for tag, paperv in [("radix", 128), ("pom", 122), ("np", 275),
                        ("pom_virt", 220)]:
        out, us = r.sys(tag)
        lat = r.avg(lambda s, sp: metrics.avg_l2tlb_miss_latency(s), out)
        rows.append((f"fig9_l2miss_lat_{tag}", us,
                     f"{lat:.0f} cyc (paper {paperv})"))
    return rows


@_figure
def fig11_reuse(r):
    out, us = r.sys("radix")
    zr = r.mean(lambda w: metrics.zero_reuse_fraction(
        out[w][1]["hist_reuse_data"]))
    return [("fig11_zero_reuse_frac", us, f"{zr*100:.0f}% (paper 92%)")]


# ---------------------------------------------------------------- Table 2


def table2_rows(results, us):
    """Table 2's rows from ``ptwcp_nn.run_study``'s results."""
    return [(f"table2_{x.name}", us,
             f"acc {x.accuracy*100:.1f}% prec {x.precision*100:.1f}%"
             f" rec {x.recall*100:.1f}% F1 {x.f1*100:.1f}%"
             f" ({x.params_bytes}B)"
             + (" (paper: F1 80.7%, 24B)"
                if x.name == "Comparator" else ""))
            for x in results]


@_figure
def table2_ptwcp(r, inits=None):
    out, us = r.sys("radix_collect")
    extras = [out[w][1] for w in r.wls]
    return table2_rows(ptwcp_nn.run_study(extras, device=r.device,
                                          inits=inits), us)


# ---------------------------------------------------------------- §9 native


@_figure
def fig20_native_speedup(r):
    base, _ = r.sys("radix")
    rows = []
    for tag, paperv in [("pom", "+1.2"), ("l3tlb_64k_15", "+2.9"),
                        ("l2tlb_64k", "+4.0"), ("l2tlb_128k", "+7.1"),
                        ("victima", "+7.4")]:
        out, us = r.sys(tag)
        sp = r.gmean_speedup(base, out)
        rows.append((f"fig20_speedup_{tag}", us,
                     f"{(sp-1)*100:.1f}% (paper {paperv}%)"))
    return rows


@_figure
def fig21_ptw_reduction(r):
    base, _ = r.sys("radix")
    rows = []
    for tag, paperv in [("pom", 37), ("l2tlb_64k", 37),
                        ("l2tlb_128k", 48), ("victima", 50)]:
        out, us = r.sys(tag)
        red = r.mean(lambda w: metrics.ptw_reduction(base[w][0], out[w][0]))
        rows.append((f"fig21_ptw_red_{tag}", us,
                     f"{red*100:.0f}% (paper {paperv}%)"))
    return rows


@_figure
def fig22_miss_latency(r):
    base, _ = r.sys("radix")
    rows = []
    for tag, paperv in [("pom", 3), ("victima", 22)]:
        out, us = r.sys(tag)
        b = r.avg(lambda s, sp: metrics.avg_l2tlb_miss_latency(s), base)
        n = r.avg(lambda s, sp: metrics.avg_l2tlb_miss_latency(s), out)
        rows.append((f"fig22_l2miss_lat_red_{tag}", us,
                     f"{(1-n/b)*100:.0f}% (paper {paperv}%)"))
    return rows


@_figure
def fig23_reach(r):
    out, us = r.sys("victima")
    reach = r.avg(lambda s, sp: metrics.translation_reach_mb(s), out)
    base_reach = metrics.baseline_l2tlb_reach_mb()
    return [("fig23_translation_reach", us,
             f"{reach:.0f} MB = {reach/base_reach:.0f}x L2TLB "
             f"(paper 220MB/36x)")]


@_figure
def fig24_tlb_block_reuse(r):
    out, us = r.sys("victima")
    hr = r.mean(lambda w: metrics.high_reuse_fraction(
        out[w][1]["hist_reuse_tlb"]))
    return [("fig24_tlb_block_reuse_gt20", us,
             f"{hr*100:.0f}% (paper 65%)")]


@_figure
def fig25_cache_size(r):
    rows = []
    for size, vtag, rtag in [("1MB", "victima_l2_1m", "radix_l2_1m"),
                             ("2MB", "victima", "radix"),
                             ("4MB", "victima_l2_4m", "radix_l2_4m"),
                             ("8MB", "victima_l2_8m", "radix_l2_8m")]:
        v, us = r.sys(vtag)
        b, _ = r.sys(rtag)
        red = r.mean(lambda w: metrics.ptw_reduction(b[w][0], v[w][0]))
        rows.append((f"fig25_ptw_red_{size}", us,
                     f"{red*100:.0f}% (paper 8MB: 63%)"))
    return rows


@_figure
def fig26_policy(r):
    ag, us = r.sys("victima_agnostic")
    aw, _ = r.sys("victima")
    sp = r.gmean_speedup(ag, aw)
    return [("fig26_tlb_aware_vs_agnostic", us,
             f"+{(sp-1)*100:.1f}% (paper +1.8%)")]


@_figure
def ablation_ptwcp(r):
    """Beyond-paper: Victima with insert-always (no PTW-CP)."""
    nop, us = r.sys("victima_noptwcp")
    yes, _ = r.sys("victima")
    sp = r.gmean_speedup(nop, yes)
    return [("ablation_ptwcp_gain", us, f"+{(sp-1)*100:.1f}% vs no-PTWCP")]


@_figure
def utopia_comparison(r):
    """Beyond-paper: Utopia vs Victima on the same axis (speedup over
    radix and PTW reduction), then Utopia's RestSeg behaviour and its
    associativity sensitivity."""
    base, _ = r.sys("radix")
    rows = []
    for tag in ("utopia", "victima", "utopia_victima"):
        out, us = r.sys(tag)
        sp = r.gmean_speedup(base, out)
        red = r.mean(lambda w: metrics.ptw_reduction(base[w][0], out[w][0]))
        rows.append((f"utopia_cmp_speedup_{tag}", us,
                     f"+{(sp-1)*100:.1f}% vs radix, "
                     f"{red*100:.0f}% fewer PTWs"))
    out, us = r.sys("utopia")
    hr = r.avg(lambda s, sp: metrics.restseg_hit_rate(s), out)
    cr = r.avg(lambda s, sp: metrics.restseg_conflict_rate(s), out)
    pc = r.avg(lambda s, sp: metrics.avg_restseg_probe_cycles(s), out)
    rows.append(("utopia_restseg_hit_rate", us,
                 f"{hr*100:.0f}% of probes walk-free "
                 f"({cr*100:.0f}% migrations conflict, "
                 f"{pc:.0f} cyc/probe)"))
    for tag in ("utopia_rs8", "utopia_rs32"):
        out, us = r.sys(tag)
        sp = r.gmean_speedup(base, out)
        rows.append((f"utopia_sens_{tag}", us,
                     f"+{(sp-1)*100:.1f}% vs radix"))
    return rows


def _walks_issued(stats) -> float:
    """Walks the system actually executed: demand walks plus Revelator's
    overlapped verification walks (every speculative resolution runs
    one; they are not in n_demand_ptw)."""
    return (float(stats.n_demand_ptw) + float(stats.n_rev_hit)
            + float(stats.n_rev_mispred))


@_figure
def scheme_comparison(r):
    """Beyond-paper: radix / Victima (reach) / Utopia (mapping) /
    Revelator (speculation) on shared hardware assumptions.  Both axes:
    critical-path PTW reduction (n_demand_ptw) and walks-issued
    reduction (demand + verification)."""
    base, _ = r.sys("radix")
    rows = []
    for tag in ("victima", "utopia", "revelator",
                "utopia_victima", "revelator_victima"):
        out, us = r.sys(tag)
        sp = r.gmean_speedup(base, out)
        red = r.mean(lambda w: metrics.ptw_reduction(base[w][0], out[w][0]))
        issued = r.mean(lambda w: metrics.reduction(
            _walks_issued(base[w][0]), _walks_issued(out[w][0])))
        rows.append((f"scheme_cmp_{tag}", us,
                     f"{(sp-1)*100:+.1f}% vs radix, "
                     f"{red*100:.0f}% fewer critical-path PTWs, "
                     f"{issued*100:.0f}% fewer walks issued"))
        if tag == "revelator":
            cov = r.avg(lambda s, sp: metrics.rev_coverage(s), out)
            acc = r.avg(lambda s, sp: metrics.rev_accuracy(s), out)
            vc = r.avg(lambda s, sp: metrics.avg_rev_verify_cycles(s), out)
            rows.append(("scheme_cmp_rev_speculation", us,
                         f"{cov*100:.0f}% of L2-TLB misses speculated "
                         f"({acc*100:.0f}% verified correct, "
                         f"{vc:.0f} cyc/verify overlapped)"))
    return rows


# ------------------------------------------------------------- multicore


MC_MIX = os.environ.get("REPRO_SIM_MIX", "bc+rnd+xs")


def _lanes(result):
    """A result as per-core-lane tuples (stats, extras): a multicore
    result already is one; a single-core result becomes a 1-lane tuple,
    so the same reductions apply.  ``Stats`` is a NamedTuple itself, so
    the per-core tuple is the one without ``_fields``."""
    stats, extras, _ = result
    if isinstance(stats, tuple) and not hasattr(stats, "_fields"):
        return stats, extras
    return (stats,), (extras,)


@_figure
def multicore_scaling(r):
    """Beyond-paper: multicore MMU scaling.  Each core count's {radix,
    victima, pom, victima + DRAM cache} family over a capacity-partitioned,
    port-contended shared L3/POM tier, the mix dealt round-robin to the
    core lanes (one core runs the mix's first component).  Rows: the mean
    per-core critical-path PTW reduction against the same-count radix,
    and the share of the shared L3's traffic that is translation
    metadata."""
    names = trace_gen.parse_mix(MC_MIX)
    rows = []
    for c in (1, 2, 4):
        wl = MC_MIX if c > 1 else names[0]
        base, _ = r.mc_sys(f"radix_{c}c", wl)
        b_stats, _ = _lanes(base)
        for scheme in ("victima", "pom", "victima_dramc"):
            out, us = r.mc_sys(f"{scheme}_{c}c", wl)
            s_stats, s_extras = _lanes(out)
            red = metrics.mean_ptw_reduction(b_stats, s_stats)
            share = float(np.mean(
                [metrics.l3_translation_share(e) for e in s_extras]))
            derived = (f"{red*100:.0f}% fewer per-core PTWs, "
                       f"L3 {share*100:.1f}% translation traffic")
            if scheme == "victima_dramc":
                hit = float(np.mean(
                    [metrics.dramc_hit_rate(e) for e in s_extras]))
                derived += f", dramc hit {hit*100:.0f}%"
            rows.append((f"multicore_{c}c_{scheme}", us, derived))
    return rows


# ---------------------------------------------------------------- §9 virt


@_figure
def fig27_virt_speedup(r):
    base, _ = r.sys("np")
    rows = []
    for tag, paperv in [("pom_virt", "+7.2"), ("isp", "+22.7"),
                        ("victima_virt", "+28.7")]:
        out, us = r.sys(tag)
        sp = r.gmean_speedup(base, out)
        rows.append((f"fig27_virt_speedup_{tag}", us,
                     f"{(sp-1)*100:.1f}% (paper {paperv}%)"))
    return rows


@_figure
def fig28_guest_host_ptws(r):
    base, _ = r.sys("np")
    out, us = r.sys("victima_virt")
    g = r.mean(lambda w: metrics.ptw_reduction(base[w][0], out[w][0]))
    h = r.mean(lambda w: metrics.host_ptw_reduction(base[w][0], out[w][0]))
    return [("fig28_guest_ptw_red", us, f"{g*100:.0f}% (paper 50%)"),
            ("fig28_host_ptw_red", us, f"{h*100:.0f}% (paper 99%)")]


@_figure
def fig29_virt_miss_latency(r):
    base, _ = r.sys("np")
    rows = []
    for tag, paperv in [("pom_virt", 20), ("isp", 54),
                        ("victima_virt", 60)]:
        out, us = r.sys(tag)
        b = r.avg(lambda s, sp: metrics.avg_l2tlb_miss_latency(s), base)
        n = r.avg(lambda s, sp: metrics.avg_l2tlb_miss_latency(s), out)
        rows.append((f"fig29_virt_l2miss_red_{tag}", us,
                     f"{(1-n/b)*100:.0f}% (paper ~{paperv}%)"))
    return rows


# the reference's ALL, in its order
ALL = [
    fig4_ptw_latency,
    fig5_fig6_fig7_l2tlb_scaling,
    fig8_l3tlb,
    fig9_stlb_miss_latency,
    fig11_reuse,
    table2_ptwcp,
    fig20_native_speedup,
    fig21_ptw_reduction,
    fig22_miss_latency,
    fig23_reach,
    fig24_tlb_block_reuse,
    fig25_cache_size,
    fig26_policy,
    ablation_ptwcp,
    utopia_comparison,
    scheme_comparison,
    multicore_scaling,
    fig27_virt_speedup,
    fig28_guest_host_ptws,
    fig29_virt_miss_latency,
]
