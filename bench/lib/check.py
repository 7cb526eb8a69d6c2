"""The comparison that decides ``correct``.

After the window closes, a sample of the window's lanes, drawn from the
run's seed, is simulated again by the plain reference
(``bench.reference``: its own trace generator and a scalar one-lane
simulator) from the workload, the trace length and the job's seed
alone, and every statistic and extra of the program's lane must equal
the reference's, leaf for leaf, dtype and all: the simulator's contract
is exactness, so the limit of ``leaf_mismatches`` is 0.  Every lane of
every job is also held to invariants of the statistics that no sound
simulation breaks (each access resolved once, every walk in the walk
histogram, no lane missing), and each system the program runs to the
configuration file's geometry.

The reference runs on a pool of worker processes (spawned; they import
numpy and the reference only), one lane a task.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import random

import numpy as np

from bench.reference import mmu as ref_mmu
from bench.reference import traces as ref_traces

EXTRA_KEYS = ("l2_access", "l2_miss", "hist_reuse_data", "hist_reuse_tlb")


def sample_lanes(traffic: dict, n_jobs: int, seed: int) -> list:
    """``traffic["check"]["lanes"]`` distinct (job index, system,
    workload) lanes of the window's `n_jobs` jobs, drawn from `seed`:
    round-robin over the strata of systems, each stratum going through
    the workloads in an order of its own."""
    if n_jobs < 1:
        return []
    rng = random.Random(f"victima-bench-check:{seed}")
    strata = traffic["check"]["strata"]
    orders = [rng.sample(traffic["workloads"], len(traffic["workloads"]))
              for _ in strata]
    total = min(traffic["check"]["lanes"],
                n_jobs * len(traffic["systems"]) * len(traffic["workloads"]))
    out, seen, i = [], set(), 0
    while len(out) < total:
        k = i % len(strata)
        w = orders[k][(i // len(strata)) % len(orders[k])]
        lane = (rng.randrange(n_jobs), rng.choice(strata[k]), w)
        i += 1
        if lane not in seen:
            seen.add(lane)
            out.append(lane)
    return out


def reference_lane(task):
    """Worker: ``task`` = (system config, workload, n, trace seed,
    sum dtype) -> the reference's (stats, extras)."""
    cfg, workload, n, seed, sum_dtype = task
    trace = ref_traces.generate(workload, n, seed)
    return ref_mmu.simulate(cfg, trace, sum_dtype)


def run_reference(tasks, workers: int) -> list:
    """The reference over `tasks` (see ``reference_lane``), in order, on
    `workers` spawned processes (0: in this process)."""
    if workers <= 0:
        return [reference_lane(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes=min(workers, len(tasks))) as pool:
        return pool.map(reference_lane, tasks, chunksize=1)


def default_workers() -> int:
    return max(1, (os.cpu_count() or 2) - 1)


def compare(port, ref) -> list[str]:
    """The names of the leaves in which the program's lane (stats,
    extras) differs from the reference's, in value, dtype or shape, or
    is missing or extra."""
    (pst, pex), (rst, rex) = port, ref
    bad = []
    for group, p, r in (("stats", pst, rst), ("extras", pex, rex)):
        for k in sorted(set(p) | set(r)):
            if k not in p or k not in r:
                bad.append(f"{group}.{k}")
                continue
            a, b = np.asarray(p[k]), np.asarray(r[k])
            if a.dtype != b.dtype or a.shape != b.shape \
                    or not np.array_equal(a, b):
                bad.append(f"{group}.{k}")
    return bad


def invariants(cfg: dict, n: int, stats: dict, extras: dict) -> list[str]:
    """The statistics' invariants one lane of system `cfg` breaks."""
    g = {k: int(v) for k, v in stats.items() if np.ndim(v) == 0}
    out = []
    if g.get("n_access") != n:
        out.append("n_access != trace length")
    if (g.get("n_l1tlb_hit", 0) + g.get("n_l2tlb_hit", 0)
            + g.get("n_l2tlb_miss", 0)) != g.get("n_access"):
        out.append("L1 hits + L2 hits + L2 misses != accesses")
    if all(cfg.get(k, v) == v for k, v in ref_mmu.UNMODELLED.items()) and (
            g.get("n_victima_hit", 0) + g.get("n_demand_ptw", 0)
            != g.get("n_l2tlb_miss")):
        out.append("Victima hits + demand walks != L2-TLB misses")
    if "hist_walk" not in stats or int(np.sum(stats["hist_walk"])) \
            != g.get("n_demand_ptw"):
        out.append("walk histogram != demand walks")
    if not cfg["victima"] and (g.get("n_victima_hit", 0)
                               or g.get("n_bg_ptw", 0)):
        out.append("Victima counts in a system without Victima")
    if not cfg["virt"] and (g.get("n_host_ptw", 0) or g.get("n_ntlb_hit", 0)):
        out.append("nested-paging counts in a native system")
    if not set(EXTRA_KEYS) <= set(extras):
        out.append("extras missing")
    return out


def config_mismatches(config: dict, systems_) -> list[str]:
    """The fields in which the program's configuration of each system
    differs from the configuration file's."""
    from bench.lib.jobs import system_config
    from repro_torch.sim import systems

    bad = []
    for name in systems_:
        cfg = systems.config(name)
        got = dataclasses.asdict(cfg)
        got["lat"] = cfg.lat._asdict()
        want = system_config(config, name)
        for k in sorted(set(got) | set(want)):
            if got.get(k) != want.get(k):
                bad.append(f"{name}.{k}: program {got.get(k)!r}, "
                           f"file {want.get(k)!r}")
    return bad
