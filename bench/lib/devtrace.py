"""Reading a ``torch.profiler`` chrome trace of the measured window.

Device operations are the trace's kernels, copies and sets; their
intervals, the harness's job annotations (``bench.job``) and the host's
torch operations lie on one clock (microseconds).  Nothing here imports
torch.
"""
from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
JOB_SPAN = "bench.job"
MMU_KERNEL = "mmu_step_kernel"


def load(path: str) -> dict:
    """``{"device": [(name, t0, t1)], "host": [(name, t0, t1)],
    "jobs": [(t0, t1)]}`` from a chrome trace, each sorted by start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host, jobs = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((e.get("name", "?"), t0, t1))
        elif cat == "user_annotation" and e.get("name") == JOB_SPAN:
            jobs.append((t0, t1))
        elif cat in HOST_CATS:
            host.append((e.get("name", "?"), t0, t1))
    return {"device": sorted(dev, key=lambda x: x[1]),
            "host": sorted(host, key=lambda x: x[1]),
            "jobs": sorted(jobs)}


def union(intervals) -> list[tuple[float, float]]:
    """Merge (t0, t1) intervals into disjoint ones, in order."""
    out: list[list[float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def kernel_busy(device, name: str = MMU_KERNEL) -> list[tuple[float, float]]:
    """The merged intervals in which a device operation whose name holds
    `name` (by default the scan kernel) ran."""
    return union((a, b) for n, a, b in device if name in n)


def kernel_us(device, lo: float, hi: float, name: str = MMU_KERNEL) -> float:
    """Microseconds of [lo, hi] in which such an operation ran."""
    return length(clip(kernel_busy(device, name), lo, hi))


def gaps(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle intervals of [lo, hi] between merged busy intervals."""
    out, t = [], lo
    for a, b in clip(merged, lo, hi):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


NAME_CHARS = 160  # a device operation's name as the breakdown gives it


def top_ops(device, lo: float, hi: float, k: int = 10):
    """The `k` device operations that took most time in [lo, hi], summed
    by name (cut to ``NAME_CHARS``): ``[[name, seconds], ...]``."""
    by: dict[str, float] = {}
    for name, a, b in device:
        name = name[:NAME_CHARS]
        a, b = max(a, lo), min(b, hi)
        if b > a:
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
    return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]


def label_gap(t0: float, t1: float, host, spans) -> str:
    """What the host was doing in the idle interval [t0, t1]: the
    innermost program span open at its middle (``spans``: (name, t0,
    t1) on the trace's clock), else the host operation that covers most
    of it where one covers half or more, else Python outside torch."""
    mid = 0.5 * (t0 + t1)
    open_ = [(b - a, n) for n, a, b in spans if a <= mid <= b]
    if open_:
        return "span " + min(open_)[1]
    best, name = 0.0, None
    for n, a, b in host:
        if a >= t1:
            break
        ov = min(b, t1) - max(a, t0)
        if ov > best:
            best, name = ov, n
    if name and best >= 0.5 * (t1 - t0):
        return f"host {name}"
    return "host python outside torch ops"
