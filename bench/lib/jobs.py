"""A cell's job: one call into the port's simulator entry, as a
researcher's sweep makes it.

``run_batch(system, workloads, n, seed, cache=False)`` for a single
system, ``run_ladder(ladder, workloads, n, seed, members=..., cache=False)``
for a sweep over a ladder's members.  Every job simulates traces of its
own seed, drawn from the run's ``--seed`` and the job's index, so no two
jobs and no two runs simulate the same traces.  The result is normalised
to ``{(system, workload): (stats, extras)}`` with the statistics as a
dict of numpy values.
"""
from __future__ import annotations

import hashlib

import numpy as np

WARMUP = -1  # the index of the set-up's warm-up job


def job_seed(seed: int, index: int) -> int:
    """The trace seed of job `index` of a run with `seed` (48 bits)."""
    h = hashlib.sha256(f"victima-bench:{seed}:{index}".encode()).digest()
    return int.from_bytes(h[:6], "little")


def system_config(config: dict, system: str) -> dict:
    """A system's full simulator configuration: the deployment's base
    with the system's own entries over it."""
    out = dict(config["simulated_system"])
    out.update(config["systems"][system])
    return out


def lanes(traffic: dict) -> list[tuple[str, str]]:
    """The (system, workload) lanes of one job, in a fixed order."""
    return [(s, w) for s in traffic["systems"] for w in traffic["workloads"]]


def accesses(traffic: dict, n: int) -> int:
    """Lane-accesses one job simulates: systems x workloads x n."""
    return len(traffic["systems"]) * len(traffic["workloads"]) * n


def _lane(result) -> tuple[dict, dict]:
    stats, extras, _spec = result
    return ({k: np.asarray(v) for k, v in stats._asdict().items()},
            dict(extras))


def run_job(traffic: dict, n: int, seed: int, device=None) -> dict:
    """Run one job of `traffic` at trace length `n` on traces of `seed`;
    returns ``{(system, workload): (stats, extras)}``."""
    from repro_torch.sim import runner

    if traffic["entry"] == "run_batch":
        (system,) = traffic["systems"]
        got = runner.run_batch(system, list(traffic["workloads"]), n=n,
                               seed=seed, cache=False, device=device)
        return {(system, w): _lane(r) for w, r in got.items()}
    got = runner.run_ladder(traffic["ladder"], list(traffic["workloads"]),
                            n=n, seed=seed, cache=False,
                            members=tuple(traffic["systems"]), device=device)
    return {(s, w): _lane(r) for s, per in got.items() for w, r in per.items()}
