"""Simulation driver: cached runs over the system registry; port of
``repro.sim.runner`` (``run``, ``run_batch`` and ``run_ladder``).

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
repeating its final workload.
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

from repro_torch.core.mmu import (make_systems_runner, simulate,
                                  simulate_batch)
from repro_torch.sim import systems, trace_gen

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
    return _load(path) if os.path.exists(path) else None


def _stack_traces(gens, n: int) -> dict:
    stacked = {k: np.stack([g["trace"][k] for g in gens], axis=1)
               for k in gens[0]["trace"]}
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
    """
    workloads = list(workloads or trace_gen.all_workloads())
    cfg = _sim_config(system, overrides)
    out = {}
    missing = []
    for w in workloads:
        got = _cached(system, w, n, seed, overrides, cache)
        if got is None:
            missing.append(w)
        else:
            out[w] = got
    if missing:
        gens = trace_gen.generate_many(missing, n=n, seed=seed)
        # overrides may change the composition (e.g. victima=True on
        # radix): let make_step re-derive the stages from the final cfg
        stage_names = None if overrides else systems.get(system).stages
        per, extras = simulate_batch(cfg, _stack_traces(gens, n),
                                     stage_names=stage_names,
                                     device=device)
        for w, g, st, ex in zip(missing, gens, per, extras):
            result = (st, ex, g["spec"])
            if cache:
                _store(_path(system, w, n, seed, overrides), result)
            out[w] = result
    return {w: out[w] for w in workloads}


def run(system: str, workload: str, n: int = 150_000, seed: int = 0,
        overrides: dict | None = None, cache: bool = True, device=None):
    """Simulate one (system, workload). Returns (stats, extras, spec).

    Results are cached on disk; ``device`` defaults to the card.
    """
    got = _cached(system, workload, n, seed, overrides, cache)
    if got is not None:
        return got
    cfg = _sim_config(system, overrides)
    stage_names = None if overrides else systems.get(system).stages
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
               device=None):
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
    ``run_batch`` writes for the same (system, workload, n, seed).
    Returns dict system -> dict workload -> result.
    """
    if ladder not in systems.LADDERS and ladder in systems.LATER:
        raise NotImplementedError(
            f"ladder {ladder!r} is not simulated by this port yet; "
            f"ROADMAP.md {systems.LATER[ladder]} ports it")
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
    chunk = chunk or CHUNK or auto_chunk(len(workloads))
    run_fn = make_systems_runner(cfg, device=device)
    with ThreadPoolExecutor(max_workers=min(len(missing),
                                            GEN_WORKERS)) as pool:
        futs = {w: pool.submit(trace_gen.generate, w, n=n, seed=seed)
                for w in missing}
        for lo in range(0, len(missing), chunk):
            group = missing[lo:lo + chunk]
            gens = [futs[w].result() for w in group]
            padded = gens + [gens[-1]] * (chunk - len(gens))
            per, extras = run_fn(dyns, _stack_traces(padded, n))
            for si, s in enumerate(members):
                for wi, (w, g) in enumerate(zip(group, gens)):
                    if w in out[s]:
                        continue  # a cached cell keeps its bytes
                    result = (per[si][wi], extras[si][wi], g["spec"])
                    if cache:
                        _store(_path(s, w, n, seed, None), result)
                    out[s][w] = result
    return out
