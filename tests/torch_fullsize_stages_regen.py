"""Regenerate tests/golden/torch_fullsize_stages_stats.json.

The snapshot holds the JAX package's Stats and extras for the systems of
the L3-TLB, POM-TLB and nested-paging compositions (``SYSTEMS``) over
all 11 workloads at the Table-3 defaults, seed 0, n accesses a workload
(``N``, stored per system), with a digest of each workload's trace at
each n -- made as tests/torch_fullsize_regen.py makes
torch_fullsize_stats.json (``repro.core.mmu.simulate_batch`` on the
CPU, traces stacked as ``repro.sim.runner.run_batch`` stacks them).
chip_smoke.py holds the port's main path on the card against it, leaf
for leaf, after checking that the port drew the same traces.

Usage:  PYTHONPATH=src:tests python tests/torch_fullsize_stages_regen.py \
            [system ...]

With system names, only those are recomputed and merged into the
existing file (the file is written after each system: the compile of a
full-size virtualized step takes minutes on a small CPU).
"""
import hashlib
import json
import os
import sys
import time

import jax.numpy as jnp
import numpy as np

from golden_trace import stats_to_jsonable
from repro.core.mmu import simulate_batch
from repro.sim import systems, trace_gen

SEED = 0
SYSTEMS = ("pom", "l3tlb_64k_15", "l3tlb_64k_24", "l3tlb_64k_39", "np",
           "victima_virt", "pom_virt", "isp")
N = dict.fromkeys(SYSTEMS, 20_000)
OUT = os.path.join(os.path.dirname(__file__), "golden",
                   "torch_fullsize_stages_stats.json")


def trace_digest(trace: dict) -> str:
    """sha256 over the vpn, is2m and line arrays, in that order."""
    h = hashlib.sha256()
    for k in ("vpn", "is2m", "line"):
        h.update(trace[k].tobytes())
    return h.hexdigest()


def workload_traces(n: int):
    names = trace_gen.all_workloads()
    gens = trace_gen.generate_many(names, n=n, seed=SEED)
    traces = {k: np.stack([g["trace"][k] for g in gens], axis=1)
              for k in gens[0]["trace"]}
    traces["ipa"] = np.broadcast_to(
        np.asarray([g["spec"].ipa for g in gens], np.float32),
        (n, len(gens)))
    digests = {w: trace_digest(g["trace"]) for w, g in zip(names, gens)}
    return names, {k: jnp.asarray(v) for k, v in traces.items()}, digests


def main(argv):
    todo = argv or list(SYSTEMS)
    unknown = sorted(set(todo) - set(SYSTEMS))
    if unknown:
        raise SystemExit(f"unknown system(s) {unknown}; known: {SYSTEMS}")
    snap = {"seed": SEED, "workloads": trace_gen.all_workloads(),
            "systems": {}, "trace_sha256": {}}
    if argv and os.path.exists(OUT):
        with open(OUT) as f:
            snap = json.load(f)
    for name in todo:
        n = N[name]
        names, traces, digests = workload_traces(n)
        assert names == snap["workloads"]
        snap["trace_sha256"][str(n)] = digests
        t0 = time.perf_counter()
        per, extras = simulate_batch(systems.config(name), traces,
                                     stage_names=systems.get(name).stages)
        snap["systems"][name] = {"n": n, "workloads": {
            w: {"stats": stats_to_jsonable(st),
                "extras": {k: np.asarray(v).tolist() for k, v in ex.items()}}
            for w, st, ex in zip(names, per, extras)}}
        print(f"[fullsize] {name}: n={n}, {time.perf_counter() - t0:.0f} s, "
              f"n_demand_ptw={[int(p.n_demand_ptw) for p in per]}",
              flush=True)
        with open(OUT, "w") as f:  # after each system: a long run keeps
            json.dump(snap, f, indent=1, sort_keys=True)  # what it made
    print(f"[fullsize] wrote {OUT}")


if __name__ == "__main__":
    main(sys.argv[1:])
