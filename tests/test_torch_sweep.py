"""run_ladder's span tree and the sweep CLI of the port, on the CPU.

The reference's ``run_ladder`` does not run under this machine's jax
(ROADMAP Queue 3), so it is no oracle here: a fill's ``LADDER_PERF``
record is held to ``obs.report.fill_record`` re-derived from the trace
file, field for field, and to ``python -m repro_torch.obs report
--check``; the sweep's cache cells are held to ``run_batch``'s, byte for
byte.  Traces run a few dozen accesses (the plain path takes ~5 ms an
access step on a CPU) over the registry's full-size configs, as the
ladder tests do.
"""
import json
import os

import pytest

import repro_torch.obs as obs
from repro_torch.kernels import build
from repro_torch.obs import __main__ as obs_cli
from repro_torch.obs import names, report
from repro_torch.sim import runner, sweep, systems

MEMBERS = ("radix", "victima")
WLS = ["bc", "rnd", "xs"]


@pytest.fixture
def trace(tmp_path, monkeypatch):
    """A fresh tracer writing to tmp_path, and a cache of its own."""
    path = str(tmp_path / "trace.jsonl")
    tr = obs.Tracer(path)
    monkeypatch.setattr(obs, "_TRACER", tr)
    monkeypatch.setattr(runner, "CACHE_DIR", str(tmp_path / "cache"))
    yield tr
    tr.close()


def children(events, parent_id, name):
    return [e for e in events if e.get("kind") == "span"
            and e["name"] == name and e["parent"] == parent_id]


def test_ladder_perf_record_re_derives_from_the_trace(trace, tmp_path):
    """Two members over three workloads in chunks of two: the record is
    fill_record of the JSONL, field for field; the tree has a trace_gen
    span a workload (on the pool threads, parented to the fill) and a
    chunk_wait and a dispatch span a chunk; ``report --check`` passes on
    the record and fails on a drifted copy."""
    before = len(runner.LADDER_PERF)
    runner.run_ladder("radix", workloads=WLS, n=24, seed=5, members=MEMBERS,
                      chunk=2, device="cpu")
    assert len(runner.LADDER_PERF) == before + 1
    rec = runner.LADDER_PERF[-1]
    events = report.read_trace(trace.path)
    assert rec == report.fill_record(events, trace_file=trace.path)
    assert list(rec) == list(report.SCHEMA6_FIELDS)
    assert {k: rec[k] for k in (
        "ladder", "n_systems", "n_members", "n_workloads", "sim_n", "chunk",
        "chunk_auto", "n_chunks", "backend", "block", "devices", "mesh",
        "cores", "t_shards", "t_rounds", "dispatch_compiles",
        "one_compile")} == {
        "ladder": "radix", "n_systems": 2, "n_members": 2, "n_workloads": 3,
        "sim_n": 24, "chunk": 2, "chunk_auto": False, "n_chunks": 2,
        "backend": "plain", "block": None, "devices": 1, "mesh": [1, 1],
        "cores": 1, "t_shards": 1, "t_rounds": None, "dispatch_compiles": 0,
        "one_compile": True}
    fill = report.fill_spans(events)[-1]
    assert len(children(events, fill["id"], names.SPAN_TRACE_GEN)) == 3
    assert len(children(events, fill["id"], names.SPAN_CHUNK_WAIT)) == 2
    assert len(children(events, fill["id"], names.SPAN_DISPATCH)) == 2
    assert rec["compile_plus_sim_wall_s"] > 0
    bench = tmp_path / "bench.json"
    bench.write_text(json.dumps({"ladder_fills": [rec]}))
    assert obs_cli.main(["report", trace.path, "--check", str(bench)]) == 0
    bench.write_text(json.dumps({"ladder_fills": [dict(rec, n_chunks=3)]}))
    assert obs_cli.main(["report", trace.path, "--check", str(bench)]) == 1


def test_kernel_library_loads_count_as_dispatch_compiles(trace, tmp_path,
                                                         monkeypatch):
    """``kernels.build.load`` emits an EV_COMPILE event (fn = the library)
    under the current span; a fill counts those of mmu_step inside its
    tree: one load in the first dispatch is one compile, and a library
    of another name counts nothing."""
    lib = tmp_path / "libmmu_step.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(build, "library_path", lambda name: str(lib))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    real = runner.make_systems_runner

    def loading_runner(cfg, stage_names=None, device=None):
        run = real(cfg, stage_names, device)
        loaded = []

        def run_once_loaded(dyns, traces):
            if not loaded:
                loaded.append(build.load("mmu_step"))
                build.load("flash_attention")
            return run(dyns, traces)
        return run_once_loaded

    monkeypatch.setattr(runner, "make_systems_runner", loading_runner)
    runner.run_ladder("radix", workloads=WLS, n=12, seed=1, members=MEMBERS,
                      chunk=2, device="cpu")
    rec = runner.LADDER_PERF[-1]
    assert rec["dispatch_compiles"] == 1 and rec["one_compile"] is True
    events = report.read_trace(trace.path)
    ev = [e for e in events if e.get("name") == names.EV_COMPILE]
    assert [e["attrs"]["fn"] for e in ev] == ["mmu_step", "flash_attention"]
    assert all(e["attrs"]["built"] is False for e in ev)
    dispatch = children(events, report.fill_spans(events)[-1]["id"],
                        names.SPAN_DISPATCH)[0]
    assert all(e["parent"] == dispatch["id"] for e in ev)
    assert rec == report.fill_record(events, trace_file=trace.path)


@pytest.mark.parametrize("mesh,time_shards", [((2, 1), 1), (None, 2)])
def test_mesh_and_time_shards_change_no_cell(trace, tmp_path, monkeypatch,
                                             mesh, time_shards):
    """A forced (2, 1) mesh (on the CPU both cells run on the one device)
    and 2 time shards give the cells of the plain fill, byte for byte,
    and the record says how the fill ran."""
    plain_dir, split_dir = tmp_path / "plain", tmp_path / "split"
    monkeypatch.setattr(runner, "CACHE_DIR", str(plain_dir))
    runner.run_ladder("radix", workloads=WLS[:2], n=16, seed=2,
                      members=MEMBERS, device="cpu")
    monkeypatch.setattr(runner, "CACHE_DIR", str(split_dir))
    runner.run_ladder("radix", workloads=WLS[:2], n=16, seed=2,
                      members=MEMBERS, device="cpu", mesh=mesh,
                      time_shards=time_shards)
    rec = runner.LADDER_PERF[-1]
    if mesh:
        assert (rec["mesh"], rec["devices"], rec["t_shards"]) == \
            ([2, 1], 2, 1)
    else:
        assert (rec["mesh"], rec["t_shards"]) == ([1, 1], 2)
        assert rec["t_rounds"] >= 1
    files = sorted(os.listdir(plain_dir))
    assert files == sorted(os.listdir(split_dir)) and len(files) == 4
    for f in files:
        assert (plain_dir / f).read_bytes() == (split_dir / f).read_bytes()


def test_sweep_over_a_tag_equals_run_batch(trace, tmp_path, monkeypatch):
    """``sweep.main`` over the l3tlb_ladder tag (three members of the
    native ladder, through run_ladder) and radix_collect (no ladder's,
    through run_batch), every workload: each cell equals, byte for byte,
    the one run_batch writes."""
    monkeypatch.setattr(sweep, "N", 16)
    sweep_dir, batch_dir = tmp_path / "sweep", tmp_path / "batch"
    monkeypatch.setattr(runner, "CACHE_DIR", str(sweep_dir))
    before = len(runner.LADDER_PERF)
    sweep.main(["radix_collect", "--tags", "l3tlb_ladder", "--device",
                "cpu"])
    assert len(runner.LADDER_PERF) == before + 1
    assert runner.LADDER_PERF[-1]["n_members"] == 3
    chosen = systems.names("l3tlb_ladder") + ["radix_collect"]
    monkeypatch.setattr(runner, "CACHE_DIR", str(batch_dir))
    for s in chosen:
        runner.run_batch(s, n=16, device="cpu")
    files = sorted(os.listdir(batch_dir))
    assert len(files) == len(chosen) * len(runner.trace_gen.all_workloads())
    assert files == sorted(os.listdir(sweep_dir))
    for f in files:
        assert (sweep_dir / f).read_bytes() == (batch_dir / f).read_bytes()


@pytest.mark.parametrize("args,match", [
    (["--cores", "2", "--mix", "bc+nosuch"], "nosuch"),
    (["--tags", "nosuchtag"], "unknown tag"),
    (["nosuchsystem"], "unknown system"),
    (["--backend", "pallas"], "unknown option '--backend'.*--device"),
    (["--devices=4"], "unknown option '--devices=4'"),
    (["--device", "tpu"], "--device wants cpu, cuda"),
    (["--device", "cuda:0,cuda:1"], "--device wants cpu, cuda"),
    (["radix_collect", "--mesh", "2x1", "--device", "cpu"], "--mesh"),
    (["--mesh", "2x2", "--time-shards", "2"], "1x1"),
])
def test_sweep_refuses_bad_arguments_before_anything_runs(monkeypatch, args,
                                                          match):
    def never(*a, **k):
        raise AssertionError("a simulation ran before the arguments were "
                             "checked")
    monkeypatch.setattr(sweep, "run_ladder", never)
    monkeypatch.setattr(sweep, "run_batch", never)
    with pytest.raises(SystemExit, match=match):
        sweep.main(args)


def test_sweep_parses_cards_and_mixes():
    names_, tags, opts = sweep.parse_args(
        ["radix", "--tags=native,virt", "--device", "cuda:1",
         "--mesh", "1x2", "--cores", "4", "--mix", "bc+rnd+xs", "--mix=gen",
         "--obs-trace", "t.jsonl", "--time-shards=1"])
    assert names_ == ["radix"] and tags == ["native", "virt"]
    assert opts == {"mesh": (1, 2), "device": "cuda:1", "time_shards": 1,
                    "obs_trace": "t.jsonl", "cores": 4,
                    "mix": ["bc+rnd+xs", "gen"]}
    assert sweep.select([], [], 2) == [
        n for n, s in systems.REGISTRY.items()
        if "multicore" in s.tags and s.config().n_cores == 2]
