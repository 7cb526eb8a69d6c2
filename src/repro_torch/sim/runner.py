"""Simulation driver: cached runs over the system registry; port of
``repro.sim.runner`` (``run``, ``run_batch`` and ``run_ladder``).

A multicore system's "workload" is a mix spec (``"bc+rnd+xs"``; a plain
name is the one-component mix): its trace is
``trace_gen.generate_mix``'s, one lane a core, and its result a
per-core tuple ``((Stats, ...), (extras, ...), (spec, ...))``, stored
under the same key as any other result.

Results are cached on disk per (system, workload, n, seed, overrides) in
the port's own directory, ``.sim_cache_torch/`` at the repository root
(``REPRO_TORCH_SIM_CACHE`` moves it); the reference's ``.sim_cache`` is
never read, since its pickles hold the reference's types.  Cache writes
are crash-safe (temp file + atomic rename) and unreadable entries count
as missing.  The device never enters a key: the card and the CPU give
the same Stats bit for bit.

``run_ladder`` fills a whole ladder of systems through one batched scan
(``mmu.make_systems_runner``), as a producer/consumer pipeline: trace
generation runs on a thread pool while the previous chunk of workloads
simulates, and every chunk has the same width, the last padded by
repeating its final workload.  Each fill runs under the reference's
``ladder_fill`` span tree (``repro_torch.obs``), and ``LADDER_PERF``
gets the record ``obs.report.fill_record`` derives from it.  A fill runs
under ``obs.torchprof.maybe_profile`` (a no-op unless
``REPRO_OBS_TORCHPROF`` names a log dir) and, where it runs on the
card, ends with one ``device_memory`` event whose peaks are the fill's
own, as the reference does with ``jaxprof``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import pickle
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import repro_torch.obs as obs
from repro_torch.core.mmu import (make_systems_runner, resolve_device,
                                  simulate, simulate_batch)
from repro_torch.obs import torchprof
from repro_torch.sim import parallel, systems, trace_gen

CACHE_DIR = os.environ.get(
    "REPRO_TORCH_SIM_CACHE",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                 "..", ".sim_cache_torch"))

# ladder dispatch width: workloads per batched call.  The last chunk
# pads by repeating its final workload, so every chunk of a fill has the
# same [S, chunk] shape, and trace generation overlaps with the previous
# chunk.  REPRO_SIM_CHUNK=auto (the default) derives the width from the
# workload count (``auto_chunk``); an integer pins it.
_chunk_env = os.environ.get("REPRO_SIM_CHUNK", "auto").strip().lower()
CHUNK: int | None = None if _chunk_env in ("", "auto") else int(_chunk_env)

# auto_chunk's ceiling on the width
CHUNK_MAX = int(os.environ.get("REPRO_SIM_CHUNK_MAX", 8))

# trace-generation threads of run_ladder's producer pool
GEN_WORKERS = int(os.environ.get("REPRO_GEN_WORKERS", 4))

# one record a run_ladder fill, in fill order: obs.report.fill_record of
# the fill's closed span tree (the function ``python -m repro_torch.obs
# report`` applies to the trace file), never assembled by hand
LADDER_PERF: list[dict] = []

# the kernel library whose builds and loads a fill's
# ``dispatch_compiles`` counts (``kernels.build`` emits an EV_COMPILE
# event, fn = the library, each time it builds or loads one)
DISPATCH_LIB = "mmu_step"


def auto_chunk(n_workloads: int, cap: int | None = None) -> int:
    """The ladder dispatch width for a workload count: fewest
    dispatches first, then the fewest padded lanes, then the narrower
    chunk.  ``cap`` bounds it (default ``CHUNK_MAX``).  It is derived
    from the full workload list, not the missing count, so a partly
    cached rerun keeps the same shape."""
    if n_workloads <= 0:
        raise ValueError(f"no workloads to chunk (n={n_workloads})")
    cap = cap or CHUNK_MAX
    return min(range(1, min(cap, n_workloads) + 1),
               key=lambda c: (math.ceil(n_workloads / c),
                              c * math.ceil(n_workloads / c) - n_workloads,
                              c))


def _sim_config(system: str, overrides: dict | None):
    """The one place a run's SimConfig is materialized (``run`` and
    ``run_batch`` store under the same key)."""
    cfg = systems.config(system)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def _canon(v):
    """Canonicalize an override value for hashing (dataclasses, the
    ``Lat`` NamedTuple and numpy scalars to tagged JSON-able values)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        fields = sorted(dataclasses.fields(v), key=lambda f: f.name)
        return {"__dataclass__": type(v).__name__,
                **{f.name: _canon(getattr(v, f.name)) for f in fields}}
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return {"__namedtuple__": type(v).__name__,
                **{k: _canon(x) for k, x in sorted(v._asdict().items())}}
    if isinstance(v, (np.generic, np.ndarray)):
        a = np.asarray(v)
        return a.item() if a.ndim == 0 else [_canon(x) for x in a.tolist()]
    if isinstance(v, dict):
        return {str(k): _canon(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(
        f"cannot canonicalize override value of type {type(v).__name__}: "
        f"{v!r}")


def _key(system: str, workload: str, n: int, seed: int,
         overrides: dict | None) -> str:
    blob = json.dumps([system, workload, n, seed, _canon(overrides or {})],
                      sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def _path(system, workload, n, seed, overrides):
    os.makedirs(CACHE_DIR, exist_ok=True)
    return os.path.join(CACHE_DIR,
                        _key(system, workload, n, seed, overrides) + ".pkl")


def _store(path: str, result) -> None:
    """Atomic pickle write: an interrupted run leaves no truncated entry."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, path)
        obs.count(obs.names.CTR_SIM_CACHE_STORE, emit=True)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _load(path: str):
    """Read a cache entry this package wrote; unreadable entries count
    as missing (anything short of a successful load means recompute)."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception:
        return None


def _cached(system, workload, n, seed, overrides, cache: bool):
    if not cache:
        return None
    path = _path(system, workload, n, seed, overrides)
    got = _load(path) if os.path.exists(path) else None
    # hit = a usable entry came back (an unreadable one is a miss)
    obs.count(obs.names.CTR_SIM_CACHE_HIT if got is not None
              else obs.names.CTR_SIM_CACHE_MISS, emit=True)
    return got


def _stack_traces(gens, n: int) -> dict:
    """The generators' traces stacked on axis 1 ([T, W], or [T, W, C]
    for mixes, which carry their own ``ipa`` and ``core`` leaves)."""
    stacked = {k: np.stack([g["trace"][k] for g in gens], axis=1)
               for k in gens[0]["trace"]}
    if "ipa" not in stacked:
        stacked["ipa"] = np.broadcast_to(
            np.asarray([g["spec"].ipa for g in gens], np.float32),
            (n, len(gens))).copy()
    return stacked


def run_batch(system: str, workloads=None, n: int = 150_000, seed: int = 0,
              overrides: dict | None = None, cache: bool = True,
              device=None):
    """Simulate one system over many workloads in one lane-batched scan.

    Fills the per-(system, workload) disk cache; returns dict
    workload -> (stats, extras, spec).  ``device`` defaults to the card.
    A call that simulates runs under a ``batch_fill`` span: trace_gen
    spans on the generating pool's threads, parented to it, inside one
    chunk_wait (the whole of the generation: nothing hides it), then one
    dispatch holding ``mmu.simulate_batch``'s stage, scan and fold.
    """
    workloads = list(workloads or trace_gen.all_workloads())
    cfg = _sim_config(system, overrides)
    if cfg.n_cores > 1:
        # a mix's core lanes fill the batch axis: one run a workload,
        # under the same cache keys
        return {w: run(system, w, n=n, seed=seed, overrides=overrides,
                       cache=cache, device=device) for w in workloads}
    out = {}
    missing = []
    for w in workloads:
        got = _cached(system, w, n, seed, overrides, cache)
        if got is None:
            missing.append(w)
        else:
            out[w] = got
    if missing:
        dev = resolve_device(device)
        # overrides may change the composition (e.g. victima=True on
        # radix): let make_step re-derive the stages from the final cfg
        stage_names = None if overrides else systems.get(system).stages
        with obs.span(obs.names.SPAN_BATCH_FILL, system=system,
                      n_workloads=len(missing), sim_n=n,
                      backend="cuda" if dev.type == "cuda" else "plain"
                      ) as fill:
            with obs.span(obs.names.SPAN_CHUNK_WAIT, workloads=missing):
                gens = trace_gen.generate_many(missing, n=n, seed=seed,
                                               parent=fill)
            with obs.span(obs.names.SPAN_DISPATCH, workloads=missing):
                stage = obs.span(obs.names.SPAN_STAGE)  # stacking counts
                per, extras = simulate_batch(cfg, _stack_traces(gens, n),
                                             stage_names=stage_names,
                                             device=dev, stage=stage)
            for w, g, st, ex in zip(missing, gens, per, extras):
                result = (st, ex, g["spec"])
                if cache:
                    _store(_path(system, w, n, seed, overrides), result)
                out[w] = result
    return {w: out[w] for w in workloads}


def run(system: str, workload: str, n: int = 150_000, seed: int = 0,
        overrides: dict | None = None, cache: bool = True, device=None):
    """Simulate one (system, workload). Returns (stats, extras, spec);
    for a multicore system `workload` is a mix spec and each of the three
    a per-core tuple.

    Results are cached on disk; ``device`` defaults to the card.
    """
    got = _cached(system, workload, n, seed, overrides, cache)
    if got is not None:
        return got
    cfg = _sim_config(system, overrides)
    stage_names = None if overrides else systems.get(system).stages
    if cfg.n_cores > 1:
        gen = trace_gen.generate_mix(workload, n=n, seed=seed,
                                     n_cores=cfg.n_cores)
        per, extras = simulate_batch(cfg, gen["trace"],
                                     stage_names=stage_names, device=device)
        result = (tuple(per), tuple(extras), gen["spec"])
        if cache:
            _store(_path(system, workload, n, seed, overrides), result)
        return result
    gen = trace_gen.generate(workload, n=n, seed=seed)
    trace = dict(gen["trace"])
    trace["ipa"] = np.full((n,), gen["spec"].ipa, np.float32)
    stats, extras = simulate(cfg, trace, stage_names=stage_names,
                             device=device)
    result = (stats, extras, gen["spec"])
    if cache:
        _store(_path(system, workload, n, seed, overrides), result)
    return result


def run_ladder(ladder: str, workloads=None, n: int = 150_000, seed: int = 0,
               cache: bool = True, members=None, chunk: int | None = None,
               device=None, mesh=None, time_shards: int = 1):
    """Fill the cache for a whole system ladder through one batched scan.

    Every member of ``systems.LADDERS[ladder]`` (or of `members`, a
    subset) runs as lanes beside the others, each with its own ``Dyn``
    geometry and gates (``mmu.make_systems_runner``; on the card one
    ``mmu_step`` launch a trace block covers them all).  Cached cells
    are reused as they are, neither recomputed nor rewritten; a workload
    re-simulates only when a member's cell is missing.  Missing
    workloads go in chunks of ``chunk`` (default ``CHUNK``, else
    ``auto_chunk`` of the full workload list), the last padded by
    repeating its final workload; padded lanes are never stored.  Trace
    generation runs on a pool of ``GEN_WORKERS`` threads while the
    previous chunk simulates.  Entries equal, byte for byte, those
    ``run_batch`` writes for the same (system, workload, n, seed).  A
    multicore family (``systems.mix_cores`` above 1) takes mix specs as
    workloads, generates their [T, C] traces and stores per-core tuples,
    as ``run`` does.  Returns dict system -> dict workload -> result.

    By default the grid runs on ``device`` alone.  ``mesh`` = (sys, wl[,
    core]) spreads it over the visible cards in that factorization
    (``parallel.plan_mesh``; on the CPU every cell runs on ``device``);
    ``time_shards > 1`` splits each trace's time axis
    (``parallel.time_shard_scan``) and needs a 1x1 mesh.  None of them
    changes a result.

    A fill that simulates runs under a ``ladder_fill`` span (trace_gen
    spans on the pool threads, parented to it explicitly; chunk_wait and
    dispatch spans for each chunk, each dispatch holding
    ``make_systems_runner``'s stage, scan and fold), and ``LADDER_PERF``
    gets ``obs.report.fill_record`` of the closed tree.  Fields that mean
    something else in torch: ``backend`` is ``"cuda"`` or ``"plain"``
    (the device's path), ``block`` is None (the kernel takes the whole
    trace a launch), ``devices`` the cells of the mesh (1 without one),
    and ``dispatch_compiles`` counts the EV_COMPILE events
    ``kernels.build`` emits when it builds or loads ``DISPATCH_LIB``
    during the fill, so that ``one_compile`` holds in a warm process;
    the event keeps the reference's name, ``xla_compile``.
    """
    members = tuple(members or systems.LADDERS[ladder])
    strays = sorted(set(members) - set(systems.LADDERS[ladder]))
    if strays:
        raise ValueError(f"{strays} are not members of ladder {ladder!r}")
    workloads = list(workloads or trace_gen.all_workloads())
    out = {s: {} for s in members}
    missing = []
    for w in workloads:
        got = {s: _cached(s, w, n, seed, None, cache) for s in members}
        for s, r in got.items():
            if r is not None:
                out[s][w] = r
        if any(r is None for r in got.values()):
            missing.append(w)
    if not missing:
        return out
    # the whole ladder's base config, even for a subset of its members:
    # each lane's view makes it exact, and it is the composition the
    # kernel's ladder instantiation runs
    cfg = systems.ladder_base_config(ladder)
    dyns = systems.ladder_dyn(members)
    n_cores = systems.mix_cores(members)
    auto = chunk is None and CHUNK is None
    chunk = chunk or CHUNK or auto_chunk(len(workloads))
    dev = resolve_device(device)
    time_shards = int(time_shards or 1)
    plan, extra = None, {}
    if mesh is not None or time_shards > 1:
        if time_shards > 1 and mesh is None:
            mesh = (1, 1)   # the time axis takes the devices
        plan = parallel.plan_mesh(
            len(members), chunk, force=tuple(mesh), n_cores=n_cores)
        extra = {"plan": plan, "time_shards": time_shards}
    run_fn = make_systems_runner(cfg, device=device, **extra)
    tr = obs.tracer()
    fill = obs.span(
        obs.names.SPAN_LADDER_FILL, ladder=ladder, n_systems=len(members),
        n_members=len(members), n_workloads=len(missing), sim_n=n,
        devices=plan.n_devices if plan else 1,
        mesh=([plan.sys_dim, plan.wl_dim] + ([plan.core_dim]
                                             if plan.core_dim > 1 else [])
              if plan else [1, 1]),
        cores=n_cores, chunk=chunk, chunk_auto=auto,
        backend="cuda" if dev.type == "cuda" else "plain", block=None,
        dispatch_fn=DISPATCH_LIB)

    def gen(w):
        # on a pool thread: the fill is attached as the parent explicitly
        with obs.span(obs.names.SPAN_TRACE_GEN, parent=fill, wl=w):
            if n_cores > 1:
                return trace_gen.generate_mix(w, n=n, seed=seed,
                                              n_cores=n_cores)
            return trace_gen.generate(w, n=n, seed=seed)

    n_chunks = 0
    torchprof.reset_device_peaks(dev)  # nothing off the card
    with fill, torchprof.maybe_profile(), ThreadPoolExecutor(
            max_workers=min(len(missing), GEN_WORKERS)) as pool:
        futs = {w: pool.submit(gen, w) for w in missing}
        for lo in range(0, len(missing), chunk):
            group = missing[lo:lo + chunk]
            with obs.span(obs.names.SPAN_CHUNK_WAIT, workloads=list(group)):
                gens = [futs[w].result() for w in group]
            pad = chunk - len(gens)
            with obs.span(obs.names.SPAN_DISPATCH, chunk_index=n_chunks,
                          workloads=list(group), cores=n_cores):
                stage = obs.span(obs.names.SPAN_STAGE)  # stacking counts
                per, extras = run_fn(
                    dyns, _stack_traces(gens + [gens[-1]] * pad, n),
                    stage=stage, padded=pad)
            n_chunks += 1
            for si, s in enumerate(members):
                for wi, (w, g) in enumerate(zip(group, gens)):
                    if w in out[s]:
                        continue  # a cached cell keeps its bytes
                    if n_cores > 1:
                        result = (tuple(per[si][wi]), tuple(extras[si][wi]),
                                  g["spec"])
                    else:
                        result = (per[si][wi], extras[si][wi], g["spec"])
                    if cache:
                        _store(_path(s, w, n, seed, None), result)
                    out[s][w] = result
        tinfo = getattr(run_fn, "last_time_shard_info", None)
        fill.set(n_chunks=n_chunks,
                 t_shards=tinfo["t_shards"] if tinfo else 1,
                 t_rounds=tinfo["rounds"] if tinfo else None)
        torchprof.device_memory_event(obs.event, dev)  # nothing off the card
    LADDER_PERF.append(obs.report.fill_record(tr.events, fill.id, tr.path))
    return out
