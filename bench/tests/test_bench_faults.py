"""A whole run of the harness on the CPU (the look for a card skipped, a
small trace length), sound and with the timed path broken underneath:
each fault a cell can have, and the control, must make ``correct``
false.  (One chip: no exchange between chips to leave out.)"""
import numpy as np
import pytest

from bench import run
from bench.lib import check as chk
from bench.lib import jobs as jb
from bench.lib import manifest

N = 64
SEED = 2**31 + 4242


@pytest.fixture(autouse=True)
def _own_result_cache(tmp_path, monkeypatch):
    """The program's result cache in an empty directory of the test's
    own, as the harness's main gives a run one."""
    from repro_torch.sim import runner

    monkeypatch.setattr(runner, "CACHE_DIR", str(tmp_path / "sim_cache"))


def _measure(cell_name):
    return run.measure(manifest.cell(cell_name), SEED, 0.0, False,
                       device="cpu", n=N, workers=0)


def _failing(out):
    return {k for k, c in out["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("cell_name", ["native.victima-t4", "virt.np-pair-t4"])
def test_sound_run_is_correct(cell_name):
    out = _measure(cell_name)
    assert out["correct"] and not _failing(out), out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"sim_accesses_per_s", "setup_s"}


@pytest.mark.parametrize("cell_name", ["native.victima-t4", "virt.np-pair-t4"])
def test_state_left_unchanged_is_caught(cell_name, monkeypatch):
    from repro_torch.kernels import mmu_step

    monkeypatch.setattr(mmu_step, "blocked_scan",
                        lambda step, st0, *a, **k: st0)
    out = _measure(cell_name)
    assert not out["correct"]
    assert {"leaf_mismatches", "invariant_violations"} <= _failing(out)


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from repro_torch.sim import runner

    real = runner.simulate_batch

    def half(cfg, traces, **kw):
        w = traces["vpn"].shape[1]
        per, extras = real(cfg, {k: v[:, : w // 2] for k, v in traces.items()},
                           **kw)
        mean = type(per[0])(*[np.asarray(np.mean([np.asarray(p[i]) for p in per],
                                                 axis=0)).astype(
                                                     np.asarray(per[0][i]).dtype)
                              for i in range(len(per[0]))])
        return per + [mean] * (w - w // 2), extras + [extras[0]] * (w - w // 2)

    monkeypatch.setattr(runner, "simulate_batch", half)
    out = _measure("native.victima-t4")
    assert not out["correct"] and "leaf_mismatches" in _failing(out)


def test_answer_altered_where_produced_is_caught(monkeypatch):
    from repro_torch.core import mmu

    real = mmu._finalize

    def altered(st, cfg):
        stats, *rest = real(st, cfg)
        return (stats._replace(sum_data_cyc=stats.sum_data_cyc + np.float32(1)),
                *rest)

    monkeypatch.setattr(mmu, "_finalize", altered)
    out = _measure("native.victima-t4")
    assert not out["correct"]
    assert _failing(out) == {"leaf_mismatches"}


def test_control_in_the_programs_place_is_caught(monkeypatch):
    """The reference with bfloat16 sums as the program: the check's
    leaf_mismatches must exceed its limit of 0."""
    def low_precision(traffic, n, seed, device=None):
        cell = manifest.cell("native.victima-t4")
        return {(s, w): chk.reference_lane((jb.system_config(cell.config, s),
                                            w, n, seed, "bfloat16"))
                for s, w in jb.lanes(traffic)}

    monkeypatch.setattr(jb, "run_job", low_precision)
    out = _measure("native.victima-t4")
    assert not out["correct"] and _failing(out) == {"leaf_mismatches"}


@pytest.mark.parametrize("cell_name,entry", [("native.victima-t4", "run_batch"),
                                             ("virt.np-pair-t4", "run_ladder")])
def test_result_cache_in_use_is_caught(cell_name, entry, monkeypatch):
    """The entry run with its result cache on: the jobs' results are
    right, but a later job with the same traces could be served from
    disk, so ``sim_cache_entries`` must exceed its limit of 0."""
    from repro_torch.sim import runner

    real = getattr(runner, entry)
    monkeypatch.setattr(runner, entry,
                        lambda *a, **k: real(*a, **dict(k, cache=True)))
    out = _measure(cell_name)
    assert not out["correct"] and _failing(out) == {"sim_cache_entries"}
