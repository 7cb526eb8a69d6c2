"""The port's ``repro_torch.obs`` (tracer, registry, report, CLI) against
the JAX package's ``repro.obs``.

- the tracer's JSONL round trip: what the file holds reads back equal to
  the in-memory events, numpy and torch values included;
- ``registry.host_value`` on Python, numpy and CPU torch scalars of each
  kind (the reference's rule for the first two; ints for integer and
  bool torch scalars, floats for floating ones, None for non-scalars);
- ``report.fill_record``, ``serve_record``, ``rollup``, ``check`` and
  ``diff`` over one event list equal the reference's;
- the ``report --check`` and ``diff --fail`` CLI exit codes;
- the port's default trace path is never the reference's.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.obs as j_obs
import repro_torch.obs as t_obs
from repro.obs import registry as j_registry
from repro.obs import report as j_report
from repro.obs.tracer import default_path as j_default_path
from repro_torch.obs import names
from repro_torch.obs import registry as t_registry
from repro_torch.obs import report as t_report
from repro_torch.obs.tracer import SCHEMA, Tracer, default_path
from repro_torch.obs.__main__ import main as t_main


def test_names_are_the_reference_s():
    from repro.obs import names as j_names
    for k in dir(j_names):
        if k.isupper():
            assert getattr(names, k) == getattr(j_names, k), k
    assert t_report.SERVE_FIELDS == j_report.SERVE_FIELDS
    assert t_report.SCHEMA6_FIELDS == j_report.SCHEMA6_FIELDS
    assert t_report.SERVE_FIELD_SOURCES == j_report.SERVE_FIELD_SOURCES
    assert t_report.FIELD_SOURCES == j_report.FIELD_SOURCES


@pytest.mark.parametrize("v", [
    True, False, 3, -7, 2.5, np.int32(4), np.int64(-9), np.uint8(200),
    np.bool_(True), np.float32(1.5), np.float64(-0.25), "x", None,
    np.array([1, 2])])
def test_host_value_on_python_and_numpy_is_the_reference_s(v):
    want = j_registry.host_value(v)
    got = t_registry.host_value(v)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("v,want", [
    (torch.tensor(5, dtype=torch.int32), 5),
    (torch.tensor(-3, dtype=torch.int64), -3),
    (torch.tensor(200, dtype=torch.uint8), 200),
    (torch.tensor(-4, dtype=torch.int8), -4),
    (torch.tensor(True), 1), (torch.tensor([7]), 7),
    (torch.tensor(2.5), 2.5), (torch.tensor(0.5, dtype=torch.float16), 0.5),
    (torch.tensor(-1.25, dtype=torch.float64), -1.25),
    (torch.tensor([1, 2]), None), (torch.zeros(0), None)])
def test_host_value_on_torch_scalars(v, want):
    got = t_registry.host_value(v)
    assert got == want
    if want is not None:
        assert type(got) is (float if v.is_floating_point() else int)
    reg = t_registry.Registry()
    assert reg.inc("c", v) == want
    assert reg.counter("c") == (want or 0)


def _emit_pipeline(ob):
    """One ladder fill and one serving run through tracer facade `ob`,
    with the values each layer really passes (numpy, torch)."""
    with ob.span(names.SPAN_LADDER_FILL, ladder="radix", n_systems=2,
                 n_members=2, n_workloads=3, sim_n=np.int64(500),
                 dispatch_fn="run_systems", devices=1, mesh="1x1",
                 chunk=3, chunk_auto=True, n_chunks=1, backend="scan",
                 block=None, t_shards=2, t_rounds=torch.tensor(2),
                 cores=1) as fill:
        for i in range(3):
            with ob.span(names.SPAN_TRACE_GEN, parent=fill, workload=i):
                pass
        with ob.span(names.SPAN_CHUNK_WAIT, chunk_i=0):
            pass
        with ob.span(names.SPAN_DISPATCH, chunk_i=0):
            ob.event(names.EV_COMPILE, fn="run_systems")
            ob.event(names.EV_COMPILE, fn="other")
            ob.event(names.EV_TIME_SHARD_ROUND, round=1,
                     known_prefix=np.int32(1), t_shards=2)
    with ob.span(names.SPAN_SERVE_RUN, run="r", arrival="poisson",
                 rate=1.5, lanes=2, mesh=1, devices=1, n_slots=4,
                 n_pool_pages=10, gate=[1, 1]) as run:
        for k in range(5):
            with ob.span(names.SPAN_DECODE_STEP):
                ob.tracer().count(names.CTR_REQS_ADMITTED, k % 2)
                ob.tracer().count(names.CTR_REQS_RETIRED, 1)
        ob.tracer().count(names.CTR_POOL_EXHAUSTED, np.int64(3))
        run.set(n_ticks=5, n_arrivals=5, pool_stall=2, vtc_hit_tc=7,
                vtc_hit_cluster=torch.tensor(2), vtc_walk=4)
    ob.count("c", 3, emit=True)
    ob.metrics_snapshot(emit=True)
    return fill, run


@pytest.fixture
def both(tmp_path):
    j = j_obs.configure(str(tmp_path / "ref.jsonl"))
    t = t_obs.configure(str(tmp_path / "port.jsonl"))
    yield j, t
    j_obs.configure()
    t_obs.configure()


def test_tracer_jsonl_round_trip(both):
    _, t = both
    _emit_pipeline(t_obs)
    t.flush()
    back = t_report.read_trace(t.path)
    assert back == t.events
    assert json.loads(json.dumps(t.events)) == t.events
    with open(t.path, encoding="utf-8") as f:
        meta = json.loads(f.readline())
    assert meta["kind"] == "meta" and meta["schema"] == SCHEMA
    # torch and numpy attrs became plain numbers
    fill = t_report.fill_spans(back)[0]
    assert fill["attrs"]["t_rounds"] == 2 and fill["attrs"]["sim_n"] == 500


def test_records_rollup_check_and_diff_are_the_reference_s(both):
    _, t = both
    fill, run = _emit_pipeline(t_obs)
    ev = t.events
    for fn in ("fill_record", "serve_record", "ladder_records",
               "serve_records", "rollup"):
        assert getattr(t_report, fn)(ev, trace_file="x") == \
            getattr(j_report, fn)(ev, trace_file="x"), fn
    rec = t_report.serve_record(ev, run.id)
    assert rec["admitted"] == 2 and rec["rejected"] == 3
    assert rec["retired"] == 5 and rec["vtc_hit_cluster"] == 2
    frec = t_report.fill_record(ev, fill.id)
    assert frec["dispatch_compiles"] == 1 and frec["t_rounds"] == 2
    good = {"ladder_fills": [frec], "serve_runs": [rec]}
    bad = {"ladder_fills": [dict(frec, n_chunks=9)],
           "serve_runs": [dict(rec, retired=0), rec]}
    for bench in (good, bad, {"ladder_fills": []}):
        assert t_report.check(ev, bench) == j_report.check(ev, bench)
    assert t_report.check(ev, good) == []
    assert len(t_report.check(ev, bad)) == 3
    slow = dict(frec, compile_plus_sim_wall_s=frec[
        "compile_plus_sim_wall_s"] + 1.0, trace_gen_wall_s=0.5)
    old, new = {"ladder_fills": [frec]}, {"ladder_fills": [slow, frec]}
    assert t_report.diff(old, new, 20.0) == j_report.diff(old, new, 20.0)
    with pytest.raises(ValueError, match="no closed 'serve.load_run'"):
        t_report.serve_record(ev, run_id=-1)


def test_cli_exit_codes(both, tmp_path, capsys):
    _, t = both
    _, run = _emit_pipeline(t_obs)
    t.flush()
    rec = t_report.serve_record(t.events, run.id)
    frec = t_report.fill_record(t.events)
    art = tmp_path / "BENCH.json"
    art.write_text(json.dumps({"schema": 1, "ladder_fills": [frec],
                               "serve_runs": [rec]}))
    assert t_main(["report", t.path, "--check", str(art)]) == 0
    assert "check OK" in capsys.readouterr().out
    art.write_text(json.dumps({"schema": 1, "ladder_fills": [frec],
                               "serve_runs": [dict(rec, vtc_walk=0)]}))
    assert t_main(["report", t.path, "--check", str(art)]) == 1
    assert "CHECK FAIL" in capsys.readouterr().err
    assert t_main(["report", t.path, "--json"]) == 0
    roll = json.loads(capsys.readouterr().out)
    assert roll["serve_runs"] == [dict(rec, trace_file=t.path)]
    old = tmp_path / "old.json"
    new = tmp_path / "new.json"
    old.write_text(json.dumps({"ladder_fills": [dict(
        frec, compile_plus_sim_wall_s=1.0)]}))
    new.write_text(json.dumps({"ladder_fills": [dict(
        frec, compile_plus_sim_wall_s=2.0)]}))
    assert t_main(["diff", str(old), str(new)]) == 0
    assert t_main(["diff", str(old), str(new), "--fail"]) == 1
    assert t_main(["diff", str(old), str(new), "--fail",
                   "--warn-pct", "150"]) == 0


def test_default_trace_path_is_the_port_s_own(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_OBS_TRACE", raising=False)
    monkeypatch.delenv("REPRO_OBS_DIR", raising=False)
    path = default_path()
    assert os.path.basename(os.path.dirname(path)) == ".obs_trace_torch"
    assert os.path.basename(path) == f"trace-torch-{os.getpid()}.jsonl"
    assert path != j_default_path()
    # under one REPRO_OBS_DIR the two packages still write two files
    monkeypatch.setenv("REPRO_OBS_DIR", str(tmp_path))
    assert os.path.dirname(default_path()) == str(tmp_path)
    assert default_path() != j_default_path()
    monkeypatch.setenv("REPRO_OBS_TRACE", str(tmp_path / "t.jsonl"))
    assert default_path() == str(tmp_path / "t.jsonl")
    # importing and configuring writes nothing until the first record
    tr = Tracer(str(tmp_path / "lazy" / "t.jsonl"))
    assert not os.path.exists(tmp_path / "lazy")
    tr.event("e")
    tr.close()
    assert os.path.exists(tmp_path / "lazy" / "t.jsonl")
