"""Regenerate tests/golden/torch_fullsize_stats.json.

The snapshot holds the JAX package's Stats and extras for the radix and
victima systems over all 11 workloads at the Table-3 defaults, n=20,000
accesses, seed 0 (``repro.core.mmu.simulate_batch`` on the CPU, traces
stacked as ``repro.sim.runner.run_batch`` stacks them), with a digest
of each workload's trace.  chip_smoke.py holds the port's main path on
the card against it, leaf for leaf, after checking that the port drew
the same traces.

Usage:  PYTHONPATH=src:tests python tests/torch_fullsize_regen.py
"""
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np

from golden_trace import stats_to_jsonable
from repro.core.mmu import simulate_batch
from repro.sim import systems, trace_gen

N = 20_000
SEED = 0
SYSTEMS = ("radix", "victima")
OUT = os.path.join(os.path.dirname(__file__), "golden",
                   "torch_fullsize_stats.json")


def trace_digest(trace: dict) -> str:
    """sha256 over the vpn, is2m and line arrays, in that order."""
    h = hashlib.sha256()
    for k in ("vpn", "is2m", "line"):
        h.update(trace[k].tobytes())
    return h.hexdigest()


def main():
    names = trace_gen.all_workloads()
    gens = trace_gen.generate_many(names, n=N, seed=SEED)
    traces = {k: np.stack([g["trace"][k] for g in gens], axis=1)
              for k in gens[0]["trace"]}
    traces["ipa"] = np.broadcast_to(
        np.asarray([g["spec"].ipa for g in gens], np.float32),
        (N, len(gens)))
    traces = {k: jnp.asarray(v) for k, v in traces.items()}
    snap = {"n": N, "seed": SEED, "workloads": names, "systems": {},
            "trace_sha256": {w: trace_digest(g["trace"])
                             for w, g in zip(names, gens)}}
    for name in SYSTEMS:
        per, extras = simulate_batch(systems.config(name), traces,
                                     stage_names=systems.get(name).stages)
        snap["systems"][name] = {
            w: {"stats": stats_to_jsonable(st),
                "extras": {k: np.asarray(v).tolist() for k, v in ex.items()}}
            for w, st, ex in zip(names, per, extras)}
        print(f"[fullsize] {name}: n_demand_ptw="
              f"{[int(p.n_demand_ptw) for p in per]}", flush=True)
    with open(OUT, "w") as f:
        json.dump(snap, f, indent=1, sort_keys=True)
    print(f"[fullsize] wrote {OUT}")


if __name__ == "__main__":
    main()
