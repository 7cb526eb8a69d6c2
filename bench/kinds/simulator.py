"""Cells whose jobs are calls into the port's trace-driven MMU simulator
(``run_batch`` or ``run_ladder``): how one job runs, what each job
records for the metrics, and the check that decides ``correct``.

A kind module gives the harness five functions:

- ``pre_check(cell) -> ({name: (value, limit)}, [log lines])``: checks
  before any job (it raises on a traffic file it cannot run);
- ``run_job(cell, n, seed, device) -> results``;
- ``after_job(cell) -> {name: (value, limit)}``: checks made after the
  warm-up and after every job (the harness compares the largest
  reading of each);
- ``job_record(cell, n, results, events) -> dict``: what the metrics
  read of one job (``work``: units of work done, here lane-accesses;
  ``floor``; ``chunk_wait_s``) and the job's invariant violations;
- ``check(cell, n, jobs, seed, workers) -> ({name: (value, limit)},
  [log lines])``: the comparison with the plain reference.
"""
from __future__ import annotations

import os

from bench.lib import check as chk
from bench.lib import jobs as jb
from bench.lib import roofline

ENTRIES = ("run_batch", "run_ladder")
CHUNK_WAIT = "chunk_wait"  # run_ladder's span of the dispatch waiting


def trace_length(cell) -> int:
    return int(cell.config["trace_length"])


def system_configs(cell) -> dict:
    return {s: jb.system_config(cell.config, s)
            for s in cell.traffic["systems"]}


def validate(cell) -> None:
    """Refuse a traffic mix whose job cannot run on the cell's
    configuration."""
    traffic, config = cell.traffic, cell.config
    where = f"cell {cell.name!r}"
    if traffic.get("entry") not in ENTRIES:
        raise ValueError(f"{where}: entry {traffic.get('entry')!r} is not "
                         f"one of {ENTRIES}")
    if traffic["entry"] == "run_batch" and len(traffic["systems"]) != 1:
        raise ValueError(f"{where}: run_batch runs one system")
    if traffic["entry"] == "run_ladder" and not traffic.get("ladder"):
        raise ValueError(f"{where}: run_ladder needs a ladder")
    for what in ("systems", "workloads"):
        unknown = sorted(set(traffic[what]) - set(config[what]))
        if unknown:
            raise ValueError(f"{where}: {what} {unknown} are not in "
                             f"configuration {config['name']!r}")
    strata = traffic["check"]["strata"]
    if (traffic["check"]["lanes"] < 1 or not strata
            or not set().union(*strata) <= set(traffic["systems"])):
        raise ValueError(f"{where}: the check's strata must name systems "
                         f"of the traffic")


def pre_check(cell):
    validate(cell)
    bad = chk.config_mismatches(cell.config, cell.traffic["systems"])
    return {"config_mismatches": (len(bad), 0)}, [
        f"check: program config differs: {b}" for b in bad[:10]]


def run_job(cell, n: int, seed: int, device=None) -> dict:
    return jb.run_job(cell.traffic, n, seed, device)


def after_job(cell) -> dict:
    """``sim_cache_entries``: files in the program's result cache.  The
    harness empties that directory before set-up and every job runs with
    ``cache=False``, so an entry there is one that a job wrote, and that
    a later job with the same traces could read instead of simulating."""
    from repro_torch.sim import runner

    n = sum(len(files) for _d, _s, files in os.walk(runner.CACHE_DIR))
    return {"sim_cache_entries": (n, 0)}


def job_record(cell, n: int, results: dict, events: list) -> dict:
    cfgs = system_configs(cell)
    want = set(jb.lanes(cell.traffic))
    bad = [f"lane {k} missing" for k in sorted(want - set(results))]
    for key, (stats, extras) in results.items():
        bad += [f"{key}: {v}" for v in chk.invariants(cfgs[key[0]], n, stats,
                                                       extras)]
    waits = [e["dur_s"] for e in events
             if e.get("kind") == "span" and e.get("name") == CHUNK_WAIT]
    return {"work": jb.accesses(cell.traffic, n),
            "floor": roofline.job_floor(cfgs, cell.traffic["workloads"], n,
                                        results),
            "chunk_wait_s": (sum(waits)
                             if cell.traffic["entry"] == "run_ladder"
                             else None),
            "violations": bad}


def check(cell, n: int, jobs: list, seed: int, workers: int):
    """Compare a sample of the window's lanes with the reference.
    ``jobs[i]`` holds ``seed`` (its trace seed) and ``results``."""
    cfgs = system_configs(cell)
    lanes = chk.sample_lanes(cell.traffic, len(jobs), seed)
    tasks = [(cfgs[s], w, n, jobs[j]["seed"], "float32")
             for j, s, w in lanes]
    refs = chk.run_reference(tasks, workers)
    mismatched = 0 if lanes else 1  # a run that checks nothing fails
    log = [f"check: {len(lanes)} lanes against the reference"]
    for (j, s, w), ref in zip(lanes, refs):
        port = jobs[j]["results"].get((s, w))
        bad = (["lane missing"] if port is None
               else chk.compare(port, ref))
        mismatched += len(bad)
        log.append(f"check: job {j} {s}/{w}: "
                   + ("equal" if not bad else "differs in " + ", ".join(bad)))
    violations = [v for j in jobs for v in j["violations"]]
    log += [f"check: invariant broken: {v}" for v in violations[:10]]
    return {"leaf_mismatches": (mismatched, 0),
            "invariant_violations": (len(violations), 0)}, log
