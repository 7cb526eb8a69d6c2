"""``repro_torch.obs`` — tracing and metrics for the port; a copy of
``repro.obs`` with the same names and record schemas.

One process-global span :class:`~repro_torch.obs.tracer.Tracer` (JSONL sink,
see ``tracer``) and one metrics :class:`~repro_torch.obs.registry.Registry`
(counters/gauges/histograms, see ``registry``), behind a module-level
facade so call sites stay one-liners::

    import repro_torch.obs as obs

    with obs.span(obs.names.SPAN_LADDER_FILL, ladder="native") as fill:
        ...
        with obs.span(obs.names.SPAN_DISPATCH, chunk_i=0):
            ...
    rec = obs.report.fill_record(obs.tracer().events, fill.id,
                                 obs.tracer().path)

Work on other threads passes ``parent=fill`` explicitly (thread-local
implicit nesting does not cross threads).  ``python -m repro_torch.obs
report`` reconstructs BENCH records from the JSONL — see ``report``.

Stdlib-only, so any layer — ``sim.parallel`` included — may import it
without cycles.  The reference's ``jaxprof`` has its counterpart in
``torchprof`` (torch.profiler and ``torch.cuda.memory_stats``), which
imports torch only when called.
"""
from __future__ import annotations

from repro_torch.obs import names, report  # noqa: F401  (re-export)
from repro_torch.obs.registry import Registry
from repro_torch.obs.tracer import Span, Tracer  # noqa: F401  (re-export)

_TRACER: Tracer | None = None
REGISTRY = Registry()


def tracer() -> Tracer:
    """The process-global tracer (created lazily at the env-derived path)."""
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer()
    return _TRACER


def configure(path: str | None = None) -> Tracer:
    """Point the global tracer at `path` (e.g. from ``--obs-trace``).

    Replaces the singleton; the previous tracer (if any) is closed.
    """
    global _TRACER
    if _TRACER is not None:
        _TRACER.close()
    _TRACER = Tracer(path)
    return _TRACER


# ------------------------------------------------------- span facade

def span(name: str, parent=None, **attrs) -> Span:
    return tracer().span(name, parent=parent, **attrs)


def event(name: str, parent=None, **attrs) -> dict:
    return tracer().event(name, parent=parent, **attrs)


def current() -> Span | None:
    return tracer().current()


def overhead_s() -> float:
    return tracer().overhead_s


# ---------------------------------------------------- metrics facade

def count(name: str, n=1, emit: bool = False, **attrs):
    """Bump registry counter `name`; with ``emit=True`` also write a
    ``count`` record to the trace.  A value that is no scalar is skipped
    — returns the applied delta or None."""
    applied = REGISTRY.inc(name, n)
    if emit and applied is not None:
        tracer().count(name, applied, **attrs)
    return applied


def gauge(name: str, v):
    return REGISTRY.gauge(name, v)


def observe(name: str, v):
    return REGISTRY.observe(name, v)


def metrics_snapshot(emit: bool = False) -> dict:
    """Registry snapshot; with ``emit=True`` also append it to the trace."""
    snap = REGISTRY.snapshot()
    if emit:
        tracer().metrics(snap)
    return snap
