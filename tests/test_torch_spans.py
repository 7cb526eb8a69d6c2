"""The simulator's job path under ``repro_torch.obs``, on the CPU.

- ``run_batch`` roots one ``batch_fill`` tree: a ``trace_gen`` span a
  workload on the generating pool's threads, parented to the root, one
  ``chunk_wait`` and one ``dispatch`` holding ``stage``, ``scan`` and
  ``fold``, each child inside its parent;
- ``run_ladder`` puts the same three children under each ``dispatch``,
  the padded chunk's lanes counted, and its ``LADDER_PERF`` record is
  still ``fill_record`` of the trace; under a mesh each block has its
  own three;
- the tracer's own time stays under 2% of a call's;
- the result cache's counters (``sim_cache.hit`` / ``miss`` / ``store``)
  count what ``cache=True`` looks up and writes, nothing with
  ``cache=False``, and ``python -m repro_torch.obs report`` sums them;
- a span's ``t0`` lies on ``torch.profiler``'s clock (the chrome
  trace's ``ts`` plus ``baseTimeNanoseconds``), read both ways the
  benchmark can.
"""
import json
import os
import sys
import threading
import time

import pytest
import torch

import repro_torch.obs as obs
from repro_torch.obs import __main__ as obs_cli
from repro_torch.obs import names, report
from repro_torch.sim import runner, trace_gen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from bench.lib import spans as bench_spans  # noqa: E402

WLS = ["bc", "rnd", "xs"]
N = 16
PHASES = [names.SPAN_STAGE, names.SPAN_SCAN, names.SPAN_FOLD]
SLACK_S = 1e-4  # t0 is wall clock, dur_s monotonic: allow their drift


@pytest.fixture
def trace(tmp_path, monkeypatch):
    """A fresh tracer writing to tmp_path, and a cache of its own."""
    tr = obs.Tracer(str(tmp_path / "trace.jsonl"))
    monkeypatch.setattr(obs, "_TRACER", tr)
    monkeypatch.setattr(runner, "CACHE_DIR", str(tmp_path / "cache"))
    yield tr
    tr.close()


def spans_of(events):
    return [e for e in events if e.get("kind") == "span"]


def children(events, parent_id, name=None):
    return sorted((e for e in spans_of(events) if e["parent"] == parent_id
                   and name in (None, e["name"])), key=lambda e: e["t0"])


def assert_nested(events, root_id):
    """Every span under `root_id` lies inside its parent's interval."""
    by_id = {e["id"]: e for e in spans_of(events)}
    under = report._descendants(events, root_id) - {root_id}
    assert under
    for i in under:
        e, p = by_id[i], by_id[by_id[i]["parent"]]
        assert p["t0"] - SLACK_S <= e["t0"], (e["name"], p["name"])
        assert e["t0"] + e["dur_s"] <= p["t0"] + p["dur_s"] + SLACK_S, \
            (e["name"], p["name"])


def test_run_batch_span_tree(trace):
    runner.run_batch("victima", WLS, n=N, seed=3, cache=False, device="cpu")
    events = trace.events
    roots = [e for e in spans_of(events) if e["parent"] is None]
    assert [r["name"] for r in roots] == [names.SPAN_BATCH_FILL]
    root = roots[0]
    assert root["attrs"] == {"system": "victima", "n_workloads": len(WLS),
                             "sim_n": N, "backend": "plain"}
    gens = children(events, root["id"], names.SPAN_TRACE_GEN)
    assert sorted(g["attrs"]["wl"] for g in gens) == sorted(WLS)
    main = threading.current_thread().name
    assert all(g["thread"] != main for g in gens)
    assert [e["name"] for e in children(events, root["id"])
            if e["name"] != names.SPAN_TRACE_GEN] == [
        names.SPAN_CHUNK_WAIT, names.SPAN_DISPATCH]
    (dispatch,) = children(events, root["id"], names.SPAN_DISPATCH)
    phases = children(events, dispatch["id"])
    assert [e["name"] for e in phases] == PHASES
    assert all(e["thread"] == main for e in phases)
    scan = phases[1]["attrs"]
    assert scan == {"lanes": len(WLS), "padded_lanes": 0,
                    "accesses": len(WLS) * N, "launches": 0}
    assert_nested(events, root["id"])
    # the generation the dispatch waited for lies inside the wait
    (wait,) = children(events, root["id"], names.SPAN_CHUNK_WAIT)
    for g in gens:
        assert wait["t0"] - SLACK_S <= g["t0"]
        assert g["t0"] + g["dur_s"] <= wait["t0"] + wait["dur_s"] + SLACK_S


def test_run_ladder_phases_under_each_dispatch(trace):
    """Two members, three workloads in chunks of two: the second chunk
    repeats its workload once, two lanes of padding."""
    runner.run_ladder("radix", workloads=WLS, n=N, seed=5,
                      members=("radix", "victima"), chunk=2, cache=False,
                      device="cpu")
    events = report.read_trace(trace.path)
    fill = report.fill_spans(events)[-1]
    assert runner.LADDER_PERF[-1] == report.fill_record(
        events, fill["id"], trace.path)
    dispatches = children(events, fill["id"], names.SPAN_DISPATCH)
    assert len(dispatches) == 2
    for d, pad in zip(dispatches, (0, 1)):
        phases = children(events, d["id"])
        assert [e["name"] for e in phases] == PHASES
        assert phases[1]["attrs"] == {"lanes": 4, "padded_lanes": 2 * pad,
                                      "accesses": 4 * N, "launches": 0}
    assert_nested(events, fill["id"])


def test_mesh_blocks_each_stage_scan_and_fold(trace):
    """Under a (2, 1) mesh (both cells on the CPU) the runner's stage
    span ends where the blocks begin, and each block stages, scans and
    folds its own lanes."""
    runner.run_ladder("radix", workloads=WLS[:2], n=8, seed=2,
                      members=("radix", "victima"), cache=False,
                      device="cpu", mesh=(2, 1))
    events = trace.events
    fill = report.fill_spans(events)[-1]
    (d,) = children(events, fill["id"], names.SPAN_DISPATCH)
    phases = children(events, d["id"])
    assert [e["name"] for e in phases] == [names.SPAN_STAGE] + PHASES * 2
    assert [e["attrs"]["lanes"] for e in phases
            if e["name"] == names.SPAN_SCAN] == [2, 2]
    assert_nested(events, fill["id"])


def test_run_s_phases_and_generate_many_without_a_parent(trace):
    """``run`` (one trace) emits the three phases at the top; a
    ``generate_many`` without a parent emits nothing and gives what it
    gave before."""
    runner.run("radix", "bc", n=8, seed=2, cache=False, device="cpu")
    assert [e["name"] for e in children(trace.events, None)] == PHASES
    before = len(trace.events)
    got = trace_gen.generate_many(["bc", "xs"], n=32, seed=4)
    assert len(trace.events) == before
    for g, w in zip(got, ["bc", "xs"]):
        one = trace_gen.generate(w, n=32, seed=4)
        assert all((g["trace"][k] == one["trace"][k]).all()
                   for k in one["trace"])


def test_tracer_overhead_is_small(trace):
    t0 = time.perf_counter()
    runner.run_batch("victima", WLS, n=N, seed=9, cache=False, device="cpu")
    wall = time.perf_counter() - t0
    assert len(spans_of(trace.events)) == len(WLS) + 6
    assert trace.overhead_s < 0.02 * wall, (trace.overhead_s, wall)


def test_cache_counters(trace, capsys):
    def counts(since):
        return report.rollup(trace.events[since:])["counters"]

    runner.run_batch("radix", WLS, n=8, seed=1, cache=True, device="cpu")
    assert counts(0) == {names.CTR_SIM_CACHE_MISS: len(WLS),
                         names.CTR_SIM_CACHE_STORE: len(WLS)}
    mark = len(trace.events)
    runner.run_batch("radix", WLS, n=8, seed=1, cache=True, device="cpu")
    assert counts(mark) == {names.CTR_SIM_CACHE_HIT: len(WLS)}
    assert not spans_of(trace.events[mark:])  # nothing simulated
    mark = len(trace.events)
    runner.run_batch("radix", WLS, n=8, seed=1, cache=False, device="cpu")
    assert counts(mark) == {}
    trace.flush()
    assert obs_cli.main(["report", trace.path, "--json"]) == 0
    roll = json.loads(capsys.readouterr().out)
    assert roll["counters"] == {names.CTR_SIM_CACHE_MISS: len(WLS),
                                names.CTR_SIM_CACHE_STORE: len(WLS),
                                names.CTR_SIM_CACHE_HIT: len(WLS)}


def test_span_clock_is_the_profiler_s(trace, tmp_path):
    """A span opened inside a ``record_function`` maps inside that
    annotation in the exported chrome trace, by the trace's base time and
    by the job offset the benchmark's readers use."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        wall0 = time.time()
        with torch.profiler.record_function("bench.job"):
            time.sleep(0.005)
            with obs.span(names.SPAN_SCAN):
                time.sleep(0.01)
            time.sleep(0.005)
    path = str(tmp_path / "chrome.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        chrome = json.load(f)
    (ann,) = [e for e in chrome["traceEvents"]
              if e.get("name") == "bench.job" and e.get("ph") == "X"]
    lo, hi = float(ann["ts"]), float(ann["ts"]) + float(ann["dur"])
    (sp,) = spans_of(trace.events)
    base_us = chrome["baseTimeNanoseconds"] / 1e3
    a, b = sp["t0"] * 1e6 - base_us, (sp["t0"] + sp["dur_s"]) * 1e6 - base_us
    assert lo <= a < b <= hi, (lo, a, b, hi)
    job = {"t0": lo, "wall0": wall0}
    a, b = bench_spans.on_trace_clock(job, sp)
    assert lo <= a < b <= hi, (lo, a, b, hi)
