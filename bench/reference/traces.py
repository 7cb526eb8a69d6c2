"""The benchmark's own copy of the synthetic trace generators (numpy only).

Frozen here so that the reference never takes the program's traces: the
generators model the paper's Table-4 workloads (GraphBIG x7, XSBench,
GUPS, DLRM, GenomicsBench) statistically, and a (workload, n, seed)
triple names one trace, byte for byte, on any numpy version.  numpy's
``Generator.zipf`` changed its rejection sampler after 2.0, so numpy
2.0's sampler is written out below (``_zipf``).

A trace is ``{"vpn": int32, "is2m": bool, "line": int32}`` of length n,
plus the workload's instructions per access (``ipa``).
"""
from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np

GB = 1 << 30
PAGE4 = 4096
LINES_PER_PAGE4 = 64  # 4 KiB / 64 B
LINE_REUSE_FRAC = 0.18  # share of page re-references that reuse the line
MAX_PAGES4 = 1 << 23    # bound on a footprint, in 4 KiB pages


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    footprint_gb: float
    thp_frac: float          # share of the footprint backed by 2 MiB pages
    zipf_a: float | None     # Zipf exponent of page popularity (None: uniform)
    seq_frac: float          # share of accesses in sequential runs
    seq_run: int             # lines a sequential run
    ipa: float = 3.0         # instructions per memory access
    reref_frac: float = 0.0  # P(revisit a recent page)
    reref_window: int = 2000
    hot_frac: float = 0.55   # P(an access lands in the hot region)
    hot_pages: int = 32_000  # hot region, in 4 KiB pages


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

_INT64_MAX = float(np.iinfo(np.int64).max)
_EPS = 2.0 ** -52


def _zipf_trial(u: float, v: float, am1: float, b: float) -> float:
    """One trial of numpy 2.0's Zipf sampler on the doubles (U, V), with
    the C library's ``pow``: the sample, or 0.0 if rejected."""
    try:
        x = float(math.floor(math.pow(1.0 - u, -1.0 / am1)))
    except OverflowError:
        return 0.0
    if x > _INT64_MAX or x < 1.0:
        return 0.0
    t = math.pow(1.0 + 1.0 / x, am1)
    return x if v * x * (t - 1.0) / (b - 1.0) <= t / b else 0.0


def _zipf(rng: np.random.Generator, a: float, n: int, cap: int) -> np.ndarray:
    """``np.minimum(rng.zipf(a, n), cap)`` as numpy 2.0 draws it.

    Each trial takes two doubles (U, V) in order, and a round draws as
    many trials as samples are still missing.  A round is computed with
    numpy, and every trial whose floor, clip or accept test lies within a
    few ulps of flipping is recomputed with ``math.pow`` (numpy's SIMD
    ``power`` may differ from the C library's in the last place).
    """
    am1 = a - 1.0
    b = math.pow(2.0, am1)
    tol = 8 * _EPS
    exact_floor = max(cap + 2.0, 2.0 ** 27)
    out = np.empty(n, np.int64)
    k = 0
    while k < n:
        u, v = rng.random(2 * (n - k)).reshape(-1, 2).T
        with np.errstate(all="ignore"):
            p = np.power(1.0 - u, -1.0 / am1)
            x = np.floor(p)
            base = 1.0 + 1.0 / x
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


def _zipf_pages(rng, n: int, n_pages: int, a: float) -> np.ndarray:
    """Zipf page ranks, scattered over the page range by a multiplicative
    permutation."""
    r = _zipf(rng, a + 1e-9 if a > 1.0 else 1.0001, n, cap=n_pages)
    r = np.minimum(r - 1, n_pages - 1)
    salt = np.uint64(0x9E3779B97F4A7C15)
    return ((r.astype(np.uint64) * salt) % np.uint64(n_pages)).astype(np.int64)


def generate(name: str, n: int, seed: int) -> dict:
    """The trace of workload `name`: ``{"vpn", "is2m", "line"}`` arrays
    of length n, and ``"ipa"``, the workload's instructions per access."""
    spec = WORKLOADS[name]
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 65536)

    n_pages = min(int(spec.footprint_gb * GB / PAGE4), MAX_PAGES4)
    n4 = int(n_pages * (1.0 - spec.thp_frac))
    n4 = max(512, n4 - (n4 % 512))  # the 4 KiB region ends on a 2 MiB line

    if spec.zipf_a is None:
        pages = rng.integers(0, n_pages, size=n, dtype=np.int64)
    else:
        pages = _zipf_pages(rng, n, n_pages, spec.zipf_a)

    if spec.hot_frac > 0:
        hot = min(spec.hot_pages, n_pages)
        hot_ids = rng.integers(0, hot, size=n)
        in_hot = rng.random(n) < spec.hot_frac
        pages = np.where(in_hot, hot_ids, pages)

    if spec.seq_frac > 0:
        n_seq = int(n * spec.seq_frac)
        n_runs = max(1, n_seq // max(spec.seq_run // LINES_PER_PAGE4, 1))
        run_pages = max(spec.seq_run // LINES_PER_PAGE4, 1)
        starts = rng.integers(0, max(n_pages - run_pages, 1), size=n_runs)
        seq = (starts[:, None] + np.arange(run_pages)[None, :]).reshape(-1)
        seq = seq[:n_seq]
        pos = rng.choice(n, size=len(seq), replace=False)
        pages[pos] = seq

    line_in_page = rng.integers(0, LINES_PER_PAGE4, size=n, dtype=np.int64)

    if spec.reref_frac > 0:
        u = rng.random(n)
        d = rng.integers(1, spec.reref_window, size=n)
        src = np.maximum(np.arange(n) - d, 0)
        take = u < spec.reref_frac
        for _ in range(4):  # chains of re-references, four links deep
            pages = np.where(take, pages[src], pages)
        same_line = take & (rng.random(n) < LINE_REUSE_FRAC)
        for _ in range(4):
            line_in_page = np.where(same_line, line_in_page[src],
                                    line_in_page)

    pages = pages % n_pages
    return {"vpn": pages.astype(np.int32),
            "is2m": (pages >= n4).astype(np.bool_),
            "line": (pages * LINES_PER_PAGE4 + line_in_page).astype(np.int32),
            "ipa": spec.ipa}
