"""The port's analysis passes (``repro_torch.analysis``) and its profiler
hook (``repro_torch.obs.torchprof``), on the CPU.

Each pass is clean on the port, and each deliberately broken input is
caught with a finding that names its code: the reference's
``tests/analysis_fixtures`` (numpy only, read as they are) and the
port's own mutants in ``tests/torch_analysis_fixtures``; a ladder member
with a difference outside ``DYN_FIELDS``; a kernel library loaded once a
chunk.  The CLI's exit codes are the reference's.  Fills run a few dozen
accesses on the plain path (~5 ms an access step on a CPU), as the sweep
tests do.
"""
import dataclasses
import importlib.util
import json
import os
import pickle
from pathlib import Path

import pytest

import repro_torch.obs as obs
from repro_torch.analysis import __main__ as analysis_cli
from repro_torch.analysis import (contracts, ladder_equiv, obs_contract,
                                  recompile)
from repro_torch.kernels import build
from repro_torch.obs import names, report, torchprof
from repro_torch.sim import runner, systems

TESTS = Path(__file__).parent
REF_FIXTURES = TESTS / "analysis_fixtures"
FIXTURES = TESTS / "torch_analysis_fixtures"


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def trace(tmp_path, monkeypatch):
    """A fresh tracer writing to tmp_path, and a result cache of its own."""
    tr = obs.Tracer(str(tmp_path / "trace.jsonl"))
    monkeypatch.setattr(obs, "_TRACER", tr)
    monkeypatch.setattr(runner, "CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("REPRO_OBS_TORCHPROF", raising=False)
    yield tr
    tr.close()


# ------------------------------------------------- the port is clean


def test_port_contracts_clean():
    assert contracts.run() == []


def test_port_obs_contract_clean():
    assert obs_contract.run() == []


def test_port_ladder_families_are_one_instantiation_each():
    reports, findings = ladder_equiv.check_all()
    assert findings == []
    by = {r.family: r for r in reports}
    assert (by["radix"].n_members, by["radix"].composition) == \
        (28, "ladder_native")
    assert (by["np"].n_members, by["np"].composition) == (5, "ladder_np")
    for c in (1, 2, 4):
        assert (by[f"radix_{c}c"].n_members,
                by[f"radix_{c}c"].composition) == (4, "ladder_mc")
    assert all(r.equivalent for r in reports)


# ----------------------------------------------- the contract checker


def test_reference_fixtures_caught_with_their_codes():
    """The reference's broken stage, fold and metrics modules, read as
    they are: C001, C005, C006, C007 and C008 name what they break."""
    stage = _load(REF_FIXTURES / "broken_stage.py")
    text = "\n".join(contracts.check_stage_objects(
        {"badsig": stage.BrokenStage()}))
    assert "C001" in text and "placeholder/missing 'name'" in text
    assert "('self', 'cfg', 'st', 'req', 'need')" in text
    fold = "\n".join(contracts.check_stats_fold(
        ("n_used", "n_orphan", "n_overwrite", "n_shared", "bad_name"),
        REF_FIXTURES / "broken_fold.py"))
    assert "C005 Stats.bad_name: violates the n_*/sum_*/hist_* naming" in fold
    assert "C005 Stats.n_orphan: not folded" in fold
    assert "C005 Stats.n_overwrite: fold is not accumulative" in fold
    assert "C006 Stats.n_shared" in fold and "Stats.n_used:" not in fold
    assert contracts.check_stats_surfaced(
        ("n_used", "n_orphan"), [REF_FIXTURES / "broken_metrics.py"]) == [
        "C007 Stats.n_orphan: orphan — accumulated every step but never "
        "read by broken_metrics.py; surface it as a metric or delete it"]
    found = contracts.check_stage_info_writes(REF_FIXTURES)
    assert len(found) == 1 and found[0].startswith("C008 broken_stage.py")


def test_stage_writing_another_stage_s_slot_named():
    found = contracts.check_stage_info_writes(FIXTURES)
    assert len(found) == 1
    assert found[0].startswith("C008 broken_stage.py:")
    assert "out['l2_tlb'].info" in found[0]


def test_gate_dropped_from_a_hoisted_local_named(tmp_path):
    """C004 reads a local assigned once through to its value: the copy
    whose ``rev_sets`` lost its gate is caught, and so is the port's own
    make_state with the virt gate of ``ntlb`` dropped inline."""
    found = contracts.check_make_state(FIXTURES / "broken_make_state.py")
    assert len(found) == 1
    assert found[0].startswith("C004 make_state: state field 'rev'")
    assert "['rev_sets']" in found[0]
    src = (contracts.STAGES_DIR / "base.py").read_text()
    gated = "mk(cfg.ntlb_sets if cfg.virt else 1, cfg.ntlb_ways)"
    assert gated in src
    mutant = tmp_path / "base.py"
    mutant.write_text(src.replace(gated, "mk(cfg.ntlb_sets, cfg.ntlb_ways)"))
    found = contracts.check_make_state(mutant)
    assert len(found) == 1 and "'ntlb'" in found[0] \
        and found[0].startswith("C004")


def test_inplace_fold_fixture_named():
    fields = ("n_used", "n_overwrite", "n_shared", "n_twice", "n_orphan",
              "hist_a", "hist_b")
    found = contracts.check_stats_fold(fields, FIXTURES / "broken_fold.py")
    text = "\n".join(found)
    assert "C005 Stats.n_overwrite: fold is not accumulative" in text
    assert "C005 Stats.n_orphan: not folded" in text
    assert "C005 Stats.n_twice: folded in 2 places" in text
    assert "C006 Stats.n_shared: written by 2 stages (['l1_tlb', " \
           "'l2_tlb'])" in text
    assert len(found) == 4   # n_used, hist_a and hist_b are clean


# ---------------------------------------------- the obs contract


def test_hand_set_ladder_perf_named():
    found = obs_contract.check_runner_appends(FIXTURES / "broken_runner.py")
    assert len(found) == 1
    assert found[0].startswith("OB001 sim/runner.py:")
    assert "hand-assembled" in found[0]


def test_duplicated_name_constant_named():
    found = obs_contract.check_name_uniqueness(
        _load(FIXTURES / "broken_names.py"))
    assert found == ["OB001 obs.names declares 'ladder_fill' more than "
                     "once — distinct metrics would silently merge"]


# ------------------------------------------------ ladder equivalence


@pytest.mark.parametrize("change,codes", [
    (dict(l1d4_sets=32), ["LE002"]),             # outside DYN_FIELDS
    (dict(virt=True), ["LE001", "LE002"]),       # another composition too
    (dict(l3tlb_sets=1024), ["LE003"]),          # a gate but no set mask
])
def test_member_that_differs_beyond_its_row_named(change, codes):
    members = systems.LADDERS["radix"]

    def config(name):
        cfg = systems.config(name)
        return dataclasses.replace(cfg, **change) \
            if name == "l3tlb_64k_15" else cfg

    rep = ladder_equiv.check_family("radix", members, config)
    assert [f.split()[0] for f in rep.findings] == codes
    assert all("family 'radix': member 'l3tlb_64k_15'" in f
               for f in rep.findings)
    assert any(k in rep.findings[-1] for k in change)
    assert not rep.equivalent


# ------------------------------------------------- the recompile guard


def test_recompile_guard_clean_on_the_plain_path(trace):
    assert recompile.check_ladder_dispatch(n=24, device="cpu") == []
    rec = runner.LADDER_PERF[-1]
    assert (rec["n_members"], rec["n_chunks"], rec["backend"],
            rec["dispatch_compiles"]) == (2, 2, "plain", 0)


def test_recompile_guard_catches_a_library_loaded_every_chunk(
        trace, tmp_path, monkeypatch):
    """A dispatch that loads mmu_step on every chunk (build.load patched
    to announce a load without nvcc) emits two EV_COMPILE events inside
    one fill: RC001."""
    lib = tmp_path / "libmmu_step.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(build, "library_path", lambda name: str(lib))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    real = runner.make_systems_runner

    def loading_runner(cfg, stage_names=None, device=None):
        run = real(cfg, stage_names, device)

        def run_loading(dyns, traces, **kw):
            build.load("mmu_step")
            return run(dyns, traces, **kw)
        return run_loading

    monkeypatch.setattr(runner, "make_systems_runner", loading_runner)
    found = recompile.check_ladder_dispatch(n=12, device="cpu")
    assert len(found) == 1 and found[0].startswith("RC001")
    assert "'mmu_step' 2x over 2 same-shape chunks" in found[0]


# ----------------------------------------------------------- the CLI


def test_cli_exit_codes(trace, monkeypatch, capsys):
    assert analysis_cli.main(["-q"]) == 0
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(obs_contract, "RUNNER_PATH",
                        FIXTURES / "broken_runner.py")
    assert analysis_cli.main(["--pass", "obs", "-q"]) == 1
    out = capsys.readouterr().out
    assert out.startswith("OB001") and "hand-assembled" in out
    with pytest.raises(SystemExit) as e:
        analysis_cli.main(["--pass", "contracts,nonsense"])
    assert e.value.code == 2


def test_cli_list_passes(capsys):
    assert analysis_cli.main(["--list"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "contracts", "ladder", "obs", "recompile  (executes)"]


# ------------------------------------------------------ the profiler


def test_torchprof_is_a_no_op_without_a_log_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_OBS_TORCHPROF", raising=False)
    monkeypatch.chdir(tmp_path)
    with torchprof.maybe_profile() as path:
        assert path is None
    assert list(tmp_path.iterdir()) == []


def test_torchprof_writes_a_trace_and_no_memory_event_on_the_cpu(
        trace, tmp_path, monkeypatch):
    """With REPRO_OBS_TORCHPROF set, a fill writes a chrome trace there;
    on the CPU no device_memory event is emitted, and the fill's cells
    and record (but its clock fields) equal an unprofiled fill's."""
    kw = dict(workloads=["bc", "rnd"], n=12, seed=3, members=("radix",
              "victima"), chunk=1, cache=False, device="cpu")
    plain = runner.run_ladder("radix", **kw)
    rec_plain = runner.LADDER_PERF[-1]
    logdir = tmp_path / "prof"
    monkeypatch.setenv("REPRO_OBS_TORCHPROF", str(logdir))
    profiled = runner.run_ladder("radix", **kw)
    rec = runner.LADDER_PERF[-1]
    files = list(logdir.iterdir())
    assert len(files) == 1 and files[0].name.startswith("torchprof-")
    assert json.loads(files[0].read_text())["traceEvents"]
    assert not [e for e in trace.events
                if e.get("name") == names.EV_DEVICE_MEMORY]
    assert torchprof.device_memory_event(obs.event, "cpu") is None
    for s in kw["members"]:
        for w in kw["workloads"]:
            assert pickle.dumps(plain[s][w]) == pickle.dumps(profiled[s][w])
    clocks = {"trace_gen_wall_s", "compile_plus_sim_wall_s",
              "trace_gen_true_wall_s"}
    assert {k: v for k, v in rec.items() if k not in clocks} == \
        {k: v for k, v in rec_plain.items() if k not in clocks}
    assert rec == report.fill_record(report.read_trace(trace.path),
                                      trace_file=trace.path)
    assert os.path.isfile(rec["trace_file"])
