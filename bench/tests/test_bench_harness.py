"""The manifest and the files it names, the metric readers on synthetic
spans and profiler events, the roofline's floor, and the harness's
refusal to run without a card (all on the CPU)."""
import json
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from bench.lib import devtrace, manifest, roofline
from bench.lib.jobs import job_seed, system_config

ROOT = manifest.ROOT
MAN = manifest.load_json(manifest.MANIFEST)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_manifest_keys_and_names():
    assert set(MAN) == TOP_KEYS
    assert MAN["paths"] == ["bench"] and MAN["command"][1] == "bench/run.py"
    assert 1 <= MAN["run_seconds"] <= 51
    names = ([c["name"] for c in MAN["configs"]]
             + [w["name"] for w in MAN["workloads"]]
             + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        for c in m.get("workloads", []):
            assert c in {w["name"] for w in MAN["workloads"]}


@pytest.mark.parametrize("cell_name", [w["name"] for w in MAN["workloads"]])
def test_every_cell_resolves_to_its_files(cell_name):
    cell = manifest.cell(cell_name)
    kind = manifest.kind(cell.traffic)
    kind.validate(cell)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert os.path.exists(manifest.metric_path(m["name"]))
        assert callable(manifest.reader(m["name"]))
    cfg_entry = next(c for c in MAN["configs"] if c["name"] == cell.config["name"])
    assert cfg_entry["file"] == os.path.relpath(
        manifest.config_path(cell.config["name"]), ROOT)
    assert cfg_entry["reduced"] == sorted(cell.config["reduced_from_source"])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        manifest.cell("no.such-cell")


def test_job_seeds_differ_and_repeat():
    seeds = [job_seed(s, i) for s in (1, 2**31 + 5) for i in range(-1, 50)]
    assert len(set(seeds)) == len(seeds)
    assert job_seed(7, 3) == job_seed(7, 3) and job_seed(7, 3) < 2**48


def _ctx(**kw):
    base = dict(setup_s=4.0, window_s=2.0, jobs=[], device=[],
                window=(0.0, 3000.0))
    base.update(kw)
    return SimpleNamespace(**base)


def test_rate_and_setup_readers():
    jobs = [{"work": 1_650_000}, {"work": 1_650_000}]
    assert manifest.reader("sim_accesses_per_s")(_ctx(jobs=jobs)) == 1_650_000
    assert manifest.reader("setup_s")(_ctx()) == 4.0
    assert manifest.reader("sim_accesses_per_s")(_ctx()) is None


K = "void (anonymous namespace)::mmu_step_kernel<true, true, 1, false>(Params)"


def test_host_gap_kernel_and_roofline_readers():
    jobs = [{"t0": 0.0, "t1": 1000.0, "floor": {"floor_s": 2e-4},
             "chunk_wait_s": 0.1},
            {"t0": 1000.0, "t1": 3000.0, "floor": {"floor_s": 3e-4},
             "chunk_wait_s": 0.3}]
    device = [(K, 100.0, 600.0), (K, 500.0, 800.0), ("Memcpy HtoD", 900.0,
                                                      950.0),
              (K, 1200.0, 2000.0)]
    ctx = _ctx(jobs=jobs, device=device)
    # job 0: 1000 us less the union 100-800; job 1: 2000 less 1200-2000
    assert manifest.reader("runner.host_gap_ms_per_job")(ctx) == \
        pytest.approx((300 + 1200) / 2 / 1e3)
    # the kernels' union (100-800, 1200-2000: 1500 us) over 2 jobs
    assert manifest.reader("mmu_step.kernel_ms_per_job")(ctx) == \
        pytest.approx(0.75)
    assert manifest.reader("mmu_step.roofline_pct")(ctx) == \
        pytest.approx(100 * 5e-4 / 1500e-6)
    # busy: 100-800, 900-950, 1200-2000 of 0-3000
    assert manifest.reader("device.idle_pct")(ctx) == \
        pytest.approx(100 * (1 - 1550 / 3000))
    assert manifest.reader("runner.chunk_wait_ms_per_job")(ctx) == \
        pytest.approx(200.0)
    for j in jobs:
        j["chunk_wait_s"] = None
    assert manifest.reader("runner.chunk_wait_ms_per_job")(ctx) is None
    ctx.device = [d for d in device if d[0] != K]
    assert manifest.reader("mmu_step.roofline_pct")(ctx) is None
    assert manifest.reader("mmu_step.kernel_ms_per_job")(ctx) is None


def test_devtrace_reads_a_chrome_trace(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": devtrace.JOB_SPAN,
           "ts": 10, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": K, "ts": 20, "dur": 30},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 60,
           "dur": 5},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 50,
           "dur": 40},
          {"ph": "i", "cat": "kernel", "name": "x", "ts": 1}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    tr = devtrace.load(str(p))
    assert tr["jobs"] == [(10.0, 110.0)]
    assert [d[0] for d in tr["device"]] == [K, "Memcpy"]
    busy = devtrace.union((a, b) for _n, a, b in tr["device"])
    assert devtrace.gaps(busy, 10.0, 110.0) == [(10.0, 20.0), (50.0, 60.0),
                                                (65.0, 110.0)]
    assert devtrace.label_gap(65.0, 90.0, tr["host"], []) == "host aten::copy_"
    assert devtrace.label_gap(90.0, 110.0, tr["host"], []) == \
        "host python outside torch ops"
    assert devtrace.label_gap(90.0, 110.0, tr["host"],
                              [("trace_gen", 80.0, 120.0)]) == "span trace_gen"
    name, secs = devtrace.top_ops(tr["device"], 10.0, 110.0)[0]
    assert name == K and secs == pytest.approx(30e-6)


def _lane(seed, **over):
    rng = np.random.default_rng(seed)
    stats = {k: np.int32(rng.integers(1000, 50000))
             for k in ("n_access", "n_l1tlb_hit", "n_l2tlb_hit", "n_l2tlb_miss",
                       "n_victima_hit", "n_demand_ptw", "n_bg_ptw",
                       "n_host_ptw", "n_ntlb_hit", "n_nvictima_hit",
                       "n_l3tlb_hit", "n_pom_hit", "n_restseg_hit",
                       "n_restseg_miss", "n_rev_hit", "n_rev_mispred")}
    stats["hist_walk"] = np.zeros(64, np.int32)
    stats.update({k: np.int32(v) for k, v in over.items()})
    return stats, {"l2_access": 40000, "l2_miss": 20000}


def test_floor_depends_only_on_stats_and_shapes():
    cell = manifest.cell("native.l2-sweep-t4")
    cfgs = {s: system_config(cell.config, s) for s in cell.traffic["systems"]}
    wls = cell.traffic["workloads"]
    res = {(s, w): _lane(i) for i, (s, w) in enumerate(
        (s, w) for s in cfgs for w in wls)}
    f1 = roofline.job_floor(cfgs, wls, 150_000, res)
    f2 = roofline.job_floor(cfgs, wls, 150_000, dict(reversed(res.items())))
    assert f1 == f2 and f1["bound"] == "rounds"
    slowest = max(res, key=lambda k: roofline.lane_rounds(cfgs[k[0]], *res[k]))
    st, ex = res[slowest]
    res[slowest] = (dict(st, n_demand_ptw=np.int32(st["n_demand_ptw"] + 1000)),
                    ex)
    f3 = roofline.job_floor(cfgs, wls, 150_000, res)
    assert f3["rounds_s"] == pytest.approx(f1["rounds_s"] + 1000
                                           * roofline.ROUND_S)
    # the geometry enters the bytes term only
    big = dict(cfgs, radix=dict(cfgs["radix"], l2_sets=8192))
    f4 = roofline.job_floor(big, wls, 150_000, res)
    assert f4["rounds_s"] == f3["rounds_s"] and f4["bytes_s"] > f3["bytes_s"]


def test_without_a_card_the_harness_refuses(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench", "run.py"), "--workload",
         "native.victima-t4", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert got.returncode != 0 and got.stdout == ""
    assert "CUDA" in got.stderr
