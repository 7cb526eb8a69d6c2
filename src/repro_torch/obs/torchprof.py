"""Optional torch.profiler passthrough and device-memory events; the
port's counterpart of ``repro.obs.jaxprof``.

The span trace says where the wall time of a fill went at pipeline
granularity; for kernel-level truth on the card, PyTorch's own profiler.
:func:`maybe_profile` wraps a block in ``torch.profiler.profile`` (CPU
activity, and CUDA activity where a card is present) when a log dir is
configured (``REPRO_OBS_TORCHPROF`` or an explicit argument), and writes
the block's chrome trace there; it is a no-op otherwise, so the sweep
pipeline calls it unconditionally.  :func:`reset_device_peaks` at the
start of a fill and :func:`device_memory_event` at its end snapshot
``torch.cuda.memory_stats()`` of each card into one ``device_memory``
trace event, whose peaks are the fill's own, where the fill runs on a
CUDA device, and do nothing elsewhere.

torch is imported inside the functions, so ``repro_torch.obs`` stays
importable, and its CLI usable on raw JSONL files, without it.
"""
from __future__ import annotations

import itertools
import os
from contextlib import contextmanager

_SEQ = itertools.count()


def profiler_logdir(logdir: str | None = None) -> str | None:
    return logdir or os.environ.get("REPRO_OBS_TORCHPROF", "").strip() or None


@contextmanager
def maybe_profile(logdir: str | None = None):
    """``torch.profiler.profile`` over the block when a log dir is
    configured, its chrome trace written on exit to
    ``<logdir>/torchprof-<pid>-<n>.json``; yields that path, or None
    (and does nothing) without a log dir."""
    logdir = profiler_logdir(logdir)
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"torchprof-{os.getpid()}-{next(_SEQ)}.json")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)


def _cards(device) -> list:
    """The indices of the cards a fill on ``device`` has touched: none
    unless ``device`` is a CUDA device."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return []
    return [i for i in range(torch.cuda.device_count())
            if torch.cuda.memory_stats(i)]


def reset_device_peaks(device) -> None:
    """Start a fill's peak: reset the peak counters of the cards in use
    where ``device`` is a CUDA device (the peak then starts at what is
    allocated now); nothing elsewhere."""
    import torch

    for i in _cards(device):
        torch.cuda.reset_peak_memory_stats(i)


def device_memory_event(emit, device):
    """Emit one ``device_memory`` event via `emit` (an ``obs.event``-shaped
    callable) with each card's ``torch.cuda.memory_stats()``, its peaks
    since :func:`reset_device_peaks`; returns the stats, {device index:
    {stat: int}}, or None (emitting nothing) unless ``device``, the
    fill's, is a CUDA device."""
    import torch

    stats = {}
    for i in _cards(device):
        stats[str(i)] = {k: int(v) for k, v in
                         torch.cuda.memory_stats(i).items()
                         if isinstance(v, (int, float))}
    if not stats:
        return None
    from repro_torch.obs import names

    emit(names.EV_DEVICE_MEMORY, devices=stats)
    return stats
