"""Regenerate tests/golden/torch_serve.json.

The snapshot holds what the JAX package's serving engine gives for the
runs ``chip_smoke.py`` phase 13 makes the port run on the card, on the
CPU:

- ``benchmarks/serve_bench.py``'s matrix at its defaults: Poisson at
  0.5 and 2.0 requests a tick per lane on 1 and 2 lanes (seed 17), one
  diurnal run at 2.0 on 2 lanes (seed 23), 300 ticks, 192 pool pages a
  lane, the default ``EngineConfig`` otherwise;
- ``benchmarks/serving.py::vtc_serving_hit_rates``'s decode storm, 700
  ticks, with 64 clusters and with 1 (the ablation);
- one run at a deployment's size: 64 slots, 4096 pool pages, 128 leaf
  rows, a TC of 64 x 4 and 256 clusters, at ``poisson_trace(6.0, 300,
  seed=17)`` on 1 lane.

For each ``run_load`` run it keeps the record without its timing fields
and ``trace_file``, and the sha256 of its arrival list (which the card
checks first, since its numpy may draw otherwise); for each storm the
VTC counters, the pool and pressure fields and the sha256 of every
state leaf, in ``jax.tree.leaves`` order.

Usage:  PYTHONPATH=src python tests/torch_serve_regen.py
"""
import hashlib
import json
import os

import jax
import numpy as np

import repro.obs as obs
from repro.serve import engine, load

OUT = os.path.join(os.path.dirname(__file__), "golden", "torch_serve.json")
TIMING = ("decode_p50_s", "decode_p99_s", "decode_mean_s", "wall_s",
          "throughput_rps", "trace_file")
TICKS, POOL = 300, 192
STORM_TICKS = 700
STORM_CFG = dict(n_slots=8, max_blocks_per_req=32, n_pool_pages=512,
                 n_leaf_rows=64, tc_sets=16, tc_ways=2)
DEPLOY_CFG = dict(n_slots=64, max_blocks_per_req=64, n_pool_pages=4096,
                  n_leaf_rows=128, tc_sets=64, tc_ways=4, n_clusters=256)


def arrivals_sha256(reqs) -> str:
    rows = [[r.arrive_tick, r.prompt_blocks, r.decode_tokens, r.kind]
            for r in reqs]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def leaves_sha256(leaves) -> str:
    h = hashlib.sha256()
    for x in leaves:
        x = np.ascontiguousarray(x)
        h.update(str(x.dtype).encode() + str(x.shape).encode())
        h.update(x.tobytes())
    return h.hexdigest()


def load_runs():
    """(name, arrival, rate, lanes, seed, ticks, cfg kwargs) of every
    run_load run, serve_bench's matrix first."""
    runs = []
    for lanes in (1, 2):
        for rate in (0.5, 2.0):
            runs.append((f"poisson_r{rate:g}_l{lanes}", "poisson",
                         rate * lanes, lanes, 17, TICKS,
                         dict(n_pool_pages=POOL)))
    runs.append(("diurnal_r2_l2", "diurnal", 4.0, 2, 23, TICKS,
                 dict(n_pool_pages=POOL)))
    runs.append(("deploy_r6_l1", "poisson", 6.0, 1, 17, TICKS, DEPLOY_CFG))
    return runs


def trace_of(arrival, rate, ticks, cfg, seed):
    fn = load.poisson_trace if arrival == "poisson" else load.diurnal_trace
    return fn(rate, ticks, cfg, seed=seed)


def storm(n_clusters: int) -> dict:
    cfg = engine.EngineConfig(**STORM_CFG, n_clusters=n_clusters)
    st = engine.init(cfg)
    for slot in range(cfg.n_slots):
        st, _ok = engine.admit(st, slot, 2 + slot % 3)
    step = jax.jit(lambda s: engine.decode_translate(s, cfg))
    for _ in range(STORM_TICKS):
        st, _phys, _src = step(st)
    st = jax.device_get(st)
    return {"n_clusters": n_clusters, "ticks": STORM_TICKS,
            "n_hit_tc": int(st.vtc.n_hit_tc),
            "n_hit_cluster": int(st.vtc.n_hit_cluster),
            "n_walk": int(st.vtc.n_walk),
            "pages_free": int(np.sum(st.page_free)),
            "pool_stall": int(st.n_pool_stall),
            "pressure": bool(st.pressure),
            "state_sha256": leaves_sha256(jax.tree.leaves(st))}


def main():
    obs.configure(os.path.join(os.environ.get("TMPDIR", "/tmp"),
                               f"torch_serve_regen-{os.getpid()}.jsonl"))
    out = {"ticks": TICKS, "pool_pages": POOL, "deploy_cfg": DEPLOY_CFG,
           "storm_cfg": STORM_CFG, "timing_fields": list(TIMING),
           "runs": [], "storms": []}
    for name, arrival, rate, lanes, seed, ticks, kw in load_runs():
        cfg = engine.EngineConfig(**kw)
        reqs = trace_of(arrival, rate, ticks, cfg, seed)
        rec = load.run_load(reqs, cfg, lanes=lanes, run=name,
                            arrival=arrival, rate=rate)
        out["runs"].append({
            "name": name, "arrival": arrival, "rate": rate,
            "lanes": lanes, "seed": seed, "ticks": ticks, "cfg": kw,
            "arrivals_sha256": arrivals_sha256(reqs),
            "record": {k: v for k, v in rec.items() if k not in TIMING}})
        print(f"{name}: {rec['n_arrivals']} arrivals, {rec['n_ticks']} "
              f"ticks, vtc {rec['vtc_hit_rate']}, rejected "
              f"{rec['rejected']}, stall {rec['pool_stall']}")
    for n_cl in (64, 1):
        out["storms"].append(storm(n_cl))
        print(f"storm n_clusters={n_cl}: {out['storms'][-1]}")
    with open(OUT, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
