"""Reading the program's own spans for the per-layer metrics.

A job's spans are the ``repro_torch.obs`` span records it left
(``ctx.jobs[i]["span_events"]``): ``name``, ``t0`` (the host's wall
clock, ``time.time()``, in seconds) and ``dur_s``.  That clock is the
profiler trace's less a constant, so the job's offset, ``t0 - wall0 *
1e6`` (its annotation's start on the trace's clock less the wall clock
read just before the annotation opened), moves its spans onto the
trace's clock in microseconds, as ``bench/run.py``'s breakdown does.
Each reader returns None when no job of the window holds a span of its
name: a program without that span reports nothing.  Nothing here
imports torch.
"""
from __future__ import annotations

from bench.lib import devtrace


def named(job: dict, name: str) -> list[dict]:
    """The job's spans named `name`, in the order they closed."""
    return [e for e in job["span_events"] if e.get("name") == name]


def wall(span: dict) -> tuple[float, float]:
    """The span's interval on the host's wall clock, in seconds."""
    return span["t0"], span["t0"] + span["dur_s"]


def offset_us(job: dict) -> float:
    """Microseconds to add to a wall-clock time (in microseconds) of the
    job's to place it on the profiler trace's clock."""
    return job["t0"] - job["wall0"] * 1e6


def on_trace_clock(job: dict, span: dict) -> tuple[float, float]:
    """The span's interval on the profiler trace's clock, in
    microseconds."""
    off = offset_us(job)
    a, b = wall(span)
    return a * 1e6 + off, b * 1e6 + off


def ms_per_job(ctx, name: str, seconds) -> float | None:
    """The mean over the window's jobs of ``seconds(job, spans)``, the
    seconds read from the job's spans named `name`, in ms; None when no
    job holds one."""
    got = [named(j, name) for j in ctx.jobs]
    if not any(got):
        return None
    return sum(seconds(j, s) for j, s in zip(ctx.jobs, got)) / len(got) * 1e3


def sum_ms_per_job(ctx, name: str) -> float | None:
    """Per job, the durations of its spans named `name` summed, in ms."""
    return ms_per_job(ctx, name, lambda _j, s: sum(e["dur_s"] for e in s))


def union_ms_per_job(ctx, name: str) -> float | None:
    """Per job, the wall time in which a span named `name` was open (the
    union of their intervals: spans on several threads that overlap
    count once), in ms."""
    return ms_per_job(ctx, name, lambda _j, s: devtrace.length(
        devtrace.union(wall(e) for e in s)))
