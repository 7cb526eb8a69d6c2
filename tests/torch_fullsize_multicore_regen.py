"""Regenerate tests/golden/torch_fullsize_multicore_stats.json.

The snapshot holds what chip_smoke.py holds the port's last systems
against, all made on the CPU from the JAX package at the registered
(Table-3) sizes, seed 0, n = 20,000 accesses a lane:

- ``systems``: ``utopia_virt`` and ``revelator_virt`` over all 11
  workloads (``repro.sim.runner.run_batch``), Stats and extras per
  workload, as the other snapshots hold them;
- ``multicore``: the twelve ``{radix,victima,pom,victima_dramc}_{1,2,4}c``
  systems through ``repro.sim.runner.run``, each on the workload
  ``multicore_scaling`` gives it (``MC_MIX``, ``bc+rnd+xs``, above one
  core; its first component, ``bc``, at one core): per core lane, Stats
  and extras;
- ``figures``: the ``(name, derived)`` rows of ``benchmarks/paper.py``'s
  own ``multicore_scaling``, its ladder warm-up bypassed
  (``_LADDER_OF = {}``, as the paper snapshot's regen does: every system
  goes to ``run_batch``, which reads ``run``'s cells above);
- ``trace_sha256``: the digests of the 11 workloads' traces at n and of
  each mix's (``generate_mix``, every leaf) at 1, 2 and 4 cores.

Usage:  PYTHONPATH=src:tests python tests/torch_fullsize_multicore_regen.py

``REPRO_SIM_CACHE`` (a fresh temporary directory when unset) is the
reference's result cache.  The file is written after each system.
"""
import hashlib
import importlib.util
import json
import os
import tempfile
import time

os.environ.setdefault("REPRO_SIM_CACHE",
                      tempfile.mkdtemp(prefix="multicore_regen_cache_"))

import numpy as np  # noqa: E402

from golden_trace import stats_to_jsonable  # noqa: E402
from repro.sim import runner, systems, trace_gen  # noqa: E402

N = 20_000
SEED = 0
HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "golden", "torch_fullsize_multicore_stats.json")
PAPER = os.path.join(HERE, "..", "benchmarks", "paper.py")
VIRT = ("utopia_virt", "revelator_virt")


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def entry(st, ex) -> dict:
    return {"stats": stats_to_jsonable(st),
            "extras": {k: np.asarray(v).tolist() for k, v in ex.items()}}


def load_paper():
    spec = importlib.util.spec_from_file_location("paper_ref", PAPER)
    paper = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(paper)
    # run_ladder fails on this tree: every system goes to run_batch
    paper._LADDER_OF = {}
    paper.N = N
    return paper


def write(snap):
    with open(OUT, "w") as f:
        json.dump(snap, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")


def main():
    paper = load_paper()
    mix = paper.MC_MIX
    first = trace_gen.parse_mix(mix)[0]
    names = trace_gen.all_workloads()
    gens = trace_gen.generate_many(names, n=N, seed=SEED)
    snap = {"n": N, "seed": SEED, "workloads": names, "mix": mix,
            "systems": {}, "multicore": {}, "trace_sha256": {
                w: sha(g["trace"]["vpn"], g["trace"]["is2m"],
                       g["trace"]["line"]) for w, g in zip(names, gens)},
            "mix_sha256": {}}
    for c in (1, 2, 4):
        wl = mix if c > 1 else first
        g = trace_gen.generate_mix(wl, n=N, seed=SEED, n_cores=c)
        snap["mix_sha256"][f"{wl}@{c}"] = sha(
            *[g["trace"][k] for k in sorted(g["trace"])])
    for name in VIRT:
        t0 = time.perf_counter()
        out = runner.run_batch(name, workloads=names, n=N, seed=SEED)
        snap["systems"][name] = {w: entry(*out[w][:2]) for w in names}
        print(f"[multicore] {name}: {time.perf_counter() - t0:.0f} s",
              flush=True)
        write(snap)
    for name in systems.names("multicore"):
        c = systems.config(name).n_cores
        wl = mix if c > 1 else first
        t0 = time.perf_counter()
        stats, extras, _ = runner.run(name, wl, n=N, seed=SEED)
        if c == 1:
            stats, extras = (stats,), (extras,)
        snap["multicore"][name] = {
            "workload": wl,
            "cores": [entry(s, e) for s, e in zip(stats, extras)]}
        print(f"[multicore] {name} on {wl}: "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
        write(snap)
    t0 = time.perf_counter()
    snap["figures"] = {"multicore_scaling": [
        [r[0], r[2]] for r in paper.multicore_scaling()]}
    print(f"[multicore] multicore_scaling: {time.perf_counter() - t0:.0f} s")
    write(snap)
    print(f"[multicore] wrote {OUT}")


if __name__ == "__main__":
    main()
