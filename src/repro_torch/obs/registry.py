"""Counters / gauges / histograms registry — the serving-side metrics path.

One process-global :class:`Registry` (held by ``repro_torch.obs``)
that ``serve.engine`` and the load harness emit into, so every
rate/latency is read from ONE place instead of ad-hoc dict math.  All
updates are lock-protected, and a value that is no scalar (a tensor of
several elements, an object with no ``float``) is silently skipped —
metrics are host-side telemetry.  Use :func:`host_value` directly to
apply the same guard to custom emission.

Histograms keep running count/sum/min/max plus a bounded sample
reservoir (first ``HIST_KEEP`` observations) — enough for the p50/p95/
p99 the serving benchmarks report without unbounded memory.

Stdlib-only, like the rest of ``repro_torch.obs`` (see ``tracer``).
"""
from __future__ import annotations

import threading

HIST_KEEP = 4096  # per-histogram sample cap (first-N reservoir)


def host_value(v):
    """Coerce to a host int/float, or None when `v` cannot concretize to
    a scalar (a tensor of several elements, an object with no ``float``).

    Integer and bool scalars (numpy or torch, on any device) stay ints,
    everything else becomes a float: a numpy dtype says which by its
    ``kind``, a torch dtype by ``is_floating_point``/``is_complex`` (it
    has no ``kind``), so this module needs neither package."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return v
    try:
        f = float(v)
    except (TypeError, ValueError, RuntimeError):
        return None
    dt = getattr(v, "dtype", None)
    kind = getattr(dt, "kind", None)
    if kind is not None:
        integer = kind in "iub"
    else:
        integer = (dt is not None and hasattr(dt, "is_floating_point")
                   and not dt.is_floating_point and not dt.is_complex)
    return int(v) if integer else f


class Registry:
    """Thread-safe named counters, gauges, and histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, dict] = {}

    # ------------------------------------------------------- updates

    def inc(self, name: str, n=1):
        """Bump a counter by `n`.  Returns the applied delta, or None
        when `n` was a tracer (update skipped)."""
        n = host_value(n)
        if n is None:
            return None
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n
        return n

    def inc_to(self, name: str, v):
        """Raise a counter to cumulative value `v` (monotone: a no-op
        when already >= v).  For sources that keep their own running
        totals — the VTC's in-state hit counters — where repeated
        sampling must be idempotent.  Tracer → skipped."""
        v = host_value(v)
        if v is None:
            return None
        with self._lock:
            self._counters[name] = max(self._counters.get(name, 0), v)
        return v

    def gauge(self, name: str, v):
        """Set a gauge to `v` (last-write-wins).  Tracer → skipped."""
        v = host_value(v)
        if v is None:
            return None
        with self._lock:
            self._gauges[name] = v
        return v

    def observe(self, name: str, v):
        """Record one histogram observation.  Tracer → skipped."""
        v = host_value(v)
        if v is None:
            return None
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = {
                    "count": 0, "sum": 0.0, "min": v, "max": v,
                    "samples": []}
            h["count"] += 1
            h["sum"] += v
            h["min"] = min(h["min"], v)
            h["max"] = max(h["max"], v)
            if len(h["samples"]) < HIST_KEEP:
                h["samples"].append(v)
        return v

    # ------------------------------------------------------- reads

    def counter(self, name: str):
        with self._lock:
            return self._counters.get(name, 0)

    def hist_stats(self, name: str) -> dict | None:
        """count/sum/mean/min/max/p50/p95/p99 for one histogram."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                return None
            s = sorted(h["samples"])
            out = {"count": h["count"], "sum": h["sum"],
                   "mean": h["sum"] / max(h["count"], 1),
                   "min": h["min"], "max": h["max"]}
        for p in (50, 95, 99):
            out[f"p{p}"] = s[min(len(s) - 1, int(len(s) * p / 100))] \
                if s else None
        return out

    def snapshot(self) -> dict:
        """Plain-dict view of everything (histograms as summary stats)."""
        with self._lock:
            hist_names = list(self._hists)
            out = {"counters": dict(self._counters),
                   "gauges": dict(self._gauges)}
        out["hists"] = {n: self.hist_stats(n) for n in hist_names}
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
