"""Synthetic memory-access trace generators (stand-ins for the paper's
Sniper traces of GraphBIG / XSBench / GUPS / DLRM / GenomicsBench).

The port's own copy of ``repro.sim.trace_gen`` (numpy, and the port's
stdlib-only ``obs`` for ``generate_many``'s spans): the same
seed gives the same trace as the reference, byte for byte, which is what
lets the port's Stats be held against the JAX package's, on any numpy
version (see ``_zipf``); multiprogrammed mixes (``generate_mix``) too.

Each generator emits a trace dict {vpn:int32, is2m:bool, line:int32} plus
metadata.  Traces are *statistically calibrated* to the paper's reported
translation behaviour: L2-TLB MPKI ≫ 5 with THP 4K/2M mixes, ~92% of L2
data blocks exhibiting zero reuse (Fig. 11), and PTW latencies centered
≈137 cycles (Fig. 4).  vpns are page ids inside a contiguous VA region
(heap-like), so upper PT levels exhibit realistic PWC locality while leaf
PTE lines carry 8-page spatial clusters — the structure Victima exploits.

``generate`` is thread-safe and seed-stable (its own
``np.random.Generator`` per call, no module state), so ``generate_many``
can run it on a thread pool and the results stay bit-identical to
one-at-a-time calls — the property the seed-keyed sim cache relies on.
"""
from __future__ import annotations

import dataclasses
import math
import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import repro_torch.obs as obs

GB = 1 << 30
PAGE4 = 4096
PAGE2 = 2 << 20
LINES_PER_PAGE4 = 64  # 4KB / 64B


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    footprint_gb: float      # dataset size
    thp_frac: float          # fraction of ACCESSES hitting 2M-backed VA
    zipf_a: float | None     # zipf exponent for hot-page skew (None=uniform)
    seq_frac: float          # fraction of accesses in sequential runs
    seq_run: int             # lines per sequential run
    ipa: float = 3.0         # instructions per memory access
    reref_frac: float = 0.0  # P(revisit a recent page); fresh line within —
    #                          page-level temporal locality WITHOUT creating
    #                          line-level cache reuse (Fig. 11 stays ~92%)
    reref_window: int = 2000
    # mid-range working set (vertex arrays / lookup tables revisited every
    # iteration): larger than the 1.5K-entry L2 TLB, within the reach of
    # large TLB structures — the regime Fig. 20/21 discriminates on.
    hot_frac: float = 0.55   # P(base access lands in the hot region)
    hot_pages: int = 32_000  # hot-region size in 4K pages (~128 MB —
    #   cycles ~2.6× per 150K-access trace, so its translations are
    #   re-usable but far outside the 1.5K-entry L2 TLB)


# 11 workloads from Table 4 (GraphBIG ×7, XSBench, GUPS, DLRM, GenomicsBench).
# thp_frac reflects real THP behaviour on these suites: dense heap arrays
# partially 2M-backed (fragmentation limits THP coverage on these
# irregular suites — consistent with the paper's mostly-4K 220MB reach); pointer-
# heavy / fragmented regions stay 4K (paper extracts page sizes from a real
# THP system, §8).
WORKLOADS: dict[str, WorkloadSpec] = {
    "bc":   WorkloadSpec("bc", 6.0, 0.30, 1.05, 0.25, 24, ipa=3.5,
                         reref_frac=0.86),
    "bfs":  WorkloadSpec("bfs", 6.0, 0.28, 1.10, 0.30, 24, ipa=3.5,
                         reref_frac=0.82),
    "cc":   WorkloadSpec("cc", 6.0, 0.30, 1.08, 0.25, 24, ipa=3.5,
                         reref_frac=0.86),
    "gc":   WorkloadSpec("gc", 6.0, 0.28, 1.05, 0.20, 16, ipa=3.0,
                         reref_frac=0.82),
    "pr":   WorkloadSpec("pr", 6.0, 0.35, 1.02, 0.30, 32, ipa=3.0,
                         reref_frac=0.88),
    "tc":   WorkloadSpec("tc", 6.0, 0.25, 1.12, 0.20, 16, ipa=3.0,
                         reref_frac=0.78),
    "sp":   WorkloadSpec("sp", 6.0, 0.30, 1.08, 0.25, 24, ipa=3.5,
                         reref_frac=0.84),
    "xs":   WorkloadSpec("xs", 9.0, 0.35, None, 0.15, 48, ipa=4.0,
                         reref_frac=0.85),
    "rnd":  WorkloadSpec("rnd", 10.0, 0.30, None, 0.00, 1, ipa=6.0,
                         reref_frac=0.0, hot_frac=0.45),
    "dlrm": WorkloadSpec("dlrm", 10.3, 0.35, 1.05, 0.20, 32, ipa=4.0,
                         reref_frac=0.82),
    "gen":  WorkloadSpec("gen", 16.0, 0.15, None, 0.10, 16, ipa=3.0,
                         reref_frac=0.70, hot_frac=0.35, hot_pages=64_000),
}

LINE_REUSE_FRAC = 0.18  # fraction of rerefs that reuse the exact line —
#                         produces the paper's ~8% non-zero L2 data reuse

MAX_PAGES4 = 1 << 23  # counter-table bound (≈32GB footprint)


_INT64_MAX = float(np.iinfo(np.int64).max)
_EPS = 2.0 ** -52


def _zipf_trial(u: float, v: float, am1: float, b: float) -> float:
    """One trial of numpy 2.0's Zipf sampler on the doubles (U, V), with
    the C library's ``pow`` as there: the sample, or 0.0 if rejected."""
    try:
        x = float(math.floor(math.pow(1.0 - u, -1.0 / am1)))
    except OverflowError:  # C's pow gives inf: rejected below
        return 0.0
    if x > _INT64_MAX or x < 1.0:
        return 0.0
    t = math.pow(1.0 + 1.0 / x, am1)
    return x if v * x * (t - 1.0) / (b - 1.0) <= t / b else 0.0


def _zipf(rng: np.random.Generator, a: float, n: int, cap: int) -> np.ndarray:
    """``np.minimum(rng.zipf(a, n), cap)`` as numpy 2.0 draws it, on any
    numpy version.

    numpy changed ``Generator.zipf``'s rejection sampler after 2.0, so
    the same seed gave other pages on a newer numpy than the one the
    reference's snapshots were made with.  This is numpy 2.0's sampler:
    each trial consumes two doubles (U, V) in order, and a round draws as
    many trials as samples are still missing, so the generator ends where
    ``rng.zipf`` leaves it.  A round is computed in numpy, but
    ``np.power`` may differ from the C library's ``pow`` in the last
    place (SIMD builds), so every trial whose floor, clip or accept test
    lies within a few ulps of flipping is recomputed by ``_zipf_trial``.
    Above ``exact_floor`` a floor one off is clipped away and moves the
    accept test by less than its band.
    """
    am1 = a - 1.0
    b = math.pow(2.0, am1)
    tol = 8 * _EPS
    exact_floor = max(cap + 2.0, 2.0 ** 27)
    out = np.empty(n, np.int64)
    k = 0
    while k < n:
        u, v = rng.random(2 * (n - k)).reshape(-1, 2).T
        with np.errstate(all="ignore"):  # pow overflow: inf, rejected
            p = np.power(1.0 - u, -1.0 / am1)
            x = np.floor(p)
            base = 1.0 + 1.0 / x
            # pow(1, y) is exactly 1 in C: such trials (x >= 2**53) are sure
            t = np.where(base == 1.0, 1.0, np.power(base, am1))
            lhs = v * x * (t - 1.0) / (b - 1.0)
            rhs = t / b
            unsure = (((p < exact_floor) & (np.abs(p - np.rint(p)) <= tol * p))
                      | (np.abs(p - _INT64_MAX) <= tol * p) | (p > 1e300)
                      | ((base != 1.0) & (np.abs(lhs - rhs)
                                          <= tol * (v * x / (b - 1.0) + rhs))))
        x = np.where((x <= _INT64_MAX) & (lhs <= rhs), x, 0.0)
        idx = np.flatnonzero(unsure)
        x[idx] = [_zipf_trial(u[j], v[j], am1, b) for j in idx.tolist()]
        got = np.minimum(x[x > 0.0], cap).astype(np.int64)
        out[k:k + len(got)] = got
        k += len(got)
    return out


def _zipf_pages(rng: np.random.Generator, n: int, n_pages: int,
                a: float) -> np.ndarray:
    """Zipf-ish page popularity via inverse-CDF over a permuted id space."""
    # sample ranks with P(r) ∝ r^-a using Zipf rejection, clipped
    r = _zipf(rng, a + 1e-9 if a > 1.0 else 1.0001, n, cap=n_pages)
    r = np.minimum(r - 1, n_pages - 1)
    # permute so hot pages are scattered across the VA region
    salt = np.uint64(0x9E3779B97F4A7C15)
    pr = (r.astype(np.uint64) * salt) % np.uint64(n_pages)
    return pr.astype(np.int64)


def generate(name: str, n: int = 400_000, seed: int = 0) -> dict:
    """Generate a trace for workload `name`.

    Returns {"trace": {vpn,is2m,line}, "spec": WorkloadSpec,
             "n_pages": int (TOTAL 4K-page-equivalents, including the
             2M-backed region), "n_pages_2m_region": int} with numpy
    arrays (callers move them to torch).

    Thread-safe and seed-stable: every call builds its OWN
    ``np.random.Generator`` from (seed, name) and touches no module
    state, so concurrent generation (``generate_many``) is bit-identical
    to sequential calls regardless of scheduling — the property the
    seed-keyed sim cache relies on.
    """
    spec = WORKLOADS[name]
    # stable per-workload salt: str.hash() is process-salted, which made
    # traces (and therefore disk-cached Stats) irreproducible across runs
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 65536)

    n_pages = min(int(spec.footprint_gb * GB / PAGE4), MAX_PAGES4)
    # VA layout: first `n4` pages are 4K-backed, rest belong to 2M regions.
    n4 = int(n_pages * (1.0 - spec.thp_frac))
    n4 = max(512, n4 - (n4 % 512))          # align to 2M boundaries
    n2_pages4 = n_pages - n4                 # 4K-page-equivalents in THP area

    # --- base random page stream (hot/cold skew)
    if spec.zipf_a is None:
        pages = rng.integers(0, n_pages, size=n, dtype=np.int64)
    else:
        pages = _zipf_pages(rng, n, n_pages, spec.zipf_a)

    # --- mid-range hot region: a CONTIGUOUS VA range (vertex array /
    # lookup-table style), so 8-page PTE clusters cover it densely —
    # 160K pages need only 20K TLB blocks (fits the 32K-block L2)
    if spec.hot_frac > 0:
        H = min(spec.hot_pages, n_pages)
        hot_ids = rng.integers(0, H, size=n)
        in_hot = rng.random(n) < spec.hot_frac
        pages = np.where(in_hot, hot_ids, pages)

    # --- splice sequential runs (streaming phases)
    if spec.seq_frac > 0:
        n_seq = int(n * spec.seq_frac)
        n_runs = max(1, n_seq // max(spec.seq_run // LINES_PER_PAGE4, 1))
        run_pages = max(spec.seq_run // LINES_PER_PAGE4, 1)
        starts = rng.integers(0, max(n_pages - run_pages, 1), size=n_runs)
        seq = (starts[:, None] + np.arange(run_pages)[None, :]).reshape(-1)
        seq = seq[: n_seq]
        pos = rng.choice(n, size=len(seq), replace=False)
        pages[pos] = seq

    line_in_page = rng.integers(0, LINES_PER_PAGE4, size=n, dtype=np.int64)

    # --- page-level temporal re-reference (see WorkloadSpec.reref_frac);
    # a minority of rerefs reuse the exact line too (L2 data reuse tail)
    if spec.reref_frac > 0:
        u = rng.random(n)
        d = rng.integers(1, spec.reref_window, size=n)
        src = np.maximum(np.arange(n) - d, 0)
        take = u < spec.reref_frac
        # resolve reref chains (a reref may point at another reref) by
        # fixed-point iteration — 4 rounds covers >99% of chains
        for _ in range(4):
            pages = np.where(take, pages[src], pages)
        same_line = take & (rng.random(n) < LINE_REUSE_FRAC)
        for _ in range(4):
            line_in_page = np.where(same_line, line_in_page[src],
                                    line_in_page)

    pages = pages % n_pages
    is2m = pages >= n4
    vpn = pages.astype(np.int32)
    line = (pages * LINES_PER_PAGE4 + line_in_page).astype(np.int32)

    return {
        "trace": {
            "vpn": vpn,
            "is2m": is2m.astype(np.bool_),
            "line": line,
        },
        "spec": spec,
        # total page count (4K-page-equivalents) — NOT just the 4K-backed
        # region; the old "n_pages4" name wrongly suggested the latter
        "n_pages": n_pages,
        "n_pages_2m_region": n2_pages4 // 512,
    }


# per-core seed skew for multiprogrammed mixes: two cores co-scheduled on
# the SAME workload must still run independent access streams (prime,
# far outside the sweep's seed range so skewed streams never collide
# with another seed's un-skewed stream)
MIX_SEED_SKEW = 7919


def parse_mix(spec: str) -> list[str]:
    """Validate a ``+``-separated co-schedule spec (``"bc+rnd+xs"``).

    Returns the component workload names in spec order.  Raises
    ``ValueError`` naming every unknown component — the same validate-
    before-compile contract as the sweep's system/tag name checks, so a
    typo dies in argument parsing instead of after minutes of tracing.
    """
    names = [s.strip() for s in str(spec).split("+")]
    if not names or any(not s for s in names):
        raise ValueError(f"malformed mix spec {spec!r} (want 'a+b+c')")
    unknown = sorted(set(s for s in names if s not in WORKLOADS))
    if unknown:
        raise ValueError(
            f"unknown workload(s) in mix {spec!r}: {', '.join(unknown)}; "
            f"known: {', '.join(WORKLOADS)}")
    return names


def generate_mix(spec: str, n: int = 400_000, seed: int = 0,
                 n_cores: int = 1, workers: int | None = None) -> dict:
    """Multiprogrammed co-schedule of ``spec`` over ``n_cores`` lanes.

    The arbiter is round-robin-with-skew: component workloads are dealt
    to core lanes round-robin (``core c`` runs ``names[c % len(names)]``,
    so a 2-workload mix on 4 cores co-schedules each twice), every lane
    is an independent ``generate`` stream whose seed is skewed per core
    (``seed + MIX_SEED_SKEW * c`` — two lanes of the SAME workload do
    not alias), and the scan interleaves the lanes in lock-step on the
    trace's core axis.  Leaf-for-leaf, lane ``c`` is bit-identical to
    the serial ``generate(names[c % k], n, seed + MIX_SEED_SKEW * c)``
    (pinned by tests/test_torch_multicore.py), so mixes inherit
    ``generate``'s thread-safety and seed-stability — the sim cache keys on
    (mix, n, seed) exactly like a plain workload.

    Returns the ``generate`` dict shape with per-core leaves [n, C],
    plus a ``core`` lane-id leaf and a per-lane ``ipa`` leaf; ``spec``
    is the tuple of per-core WorkloadSpecs.
    """
    names = parse_mix(spec)
    if n_cores < 1:
        raise ValueError(f"n_cores must be >= 1, got {n_cores}")
    assign = [names[c % len(names)] for c in range(n_cores)]
    workers = workers or min(n_cores, os.cpu_count() or 1, 8)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        outs = list(pool.map(
            lambda c: generate(assign[c], n=n,
                               seed=seed + MIX_SEED_SKEW * c),
            range(n_cores)))
    trace = {k: np.stack([o["trace"][k] for o in outs], axis=1)
             for k in outs[0]["trace"]}
    trace["core"] = np.broadcast_to(
        np.arange(n_cores, dtype=np.int32), (n, n_cores))
    trace["ipa"] = np.broadcast_to(
        np.asarray([o["spec"].ipa for o in outs], dtype=np.float32),
        (n, n_cores))
    return {
        "trace": trace,
        "spec": tuple(o["spec"] for o in outs),
        "n_pages": max(o["n_pages"] for o in outs),
        "n_pages_2m_region": max(o["n_pages_2m_region"] for o in outs),
    }


def generate_many(names, n: int = 400_000, seed: int = 0,
                  workers: int | None = None, parent=None) -> list[dict]:
    """Generate traces for ``names`` on a thread pool, in input order.

    numpy releases the GIL inside its kernels, so generation genuinely
    overlaps on multi-core hosts; results are bit-identical to serial
    ``generate`` calls (see its thread-safety note — pinned by
    the reference's tests/test_parallel.py for seeds 0/1/7).  With
    `parent` (an ``obs`` span or its id) each workload's generation runs
    in a ``trace_gen`` span on its pool thread, parented to it.
    """
    names = list(names)
    if not names:
        return []
    workers = workers or min(len(names), os.cpu_count() or 1, 8)

    def gen(w):
        if parent is None:
            return generate(w, n=n, seed=seed)
        with obs.span(obs.names.SPAN_TRACE_GEN, parent=parent, wl=w):
            return generate(w, n=n, seed=seed)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(gen, names))


def all_workloads() -> list[str]:
    return list(WORKLOADS.keys())
