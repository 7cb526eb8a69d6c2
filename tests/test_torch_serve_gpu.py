"""The serving engine and the time-sharded simulator on the card.

The ``gpu`` tests need the card and skip elsewhere; they import no jax:

    PYTHONPATH=src:tests python -m pytest -q --noconftest -m gpu \
        tests/test_torch_serve_gpu.py

- the engine on ``cuda`` equals the engine on ``cpu``, every state leaf
  of both lanes, tick by tick over a seeded load with pool exhaustion,
  stalls, retirements and pressure epochs, and ``run_load``'s records
  agree but for the timing fields (the CPU side is held against the JAX
  package by tests/test_torch_serve.py);
- a time-sharded run of the ``mmu_step`` kernel equals its serial run,
  every Stats leaf, one launch a hand-off round.
"""
import numpy as np
import pytest
import torch

import repro_torch.obs as obs
from repro_torch.core import mmu
from repro_torch.core.stages import SimConfig
from repro_torch.kernels import mmu_step
from repro_torch.serve import engine, load
from repro_torch.sim import parallel, systems
from test_torch_kernel import TINY, cuda, workload_traces  # noqa: F401

CFG = engine.EngineConfig(n_slots=6, max_blocks_per_req=8, n_pool_pages=28,
                          n_leaf_rows=16, tc_sets=4, tc_ways=2,
                          n_clusters=16, pressure_epoch=8,
                          pressure_thresh=0.15)


def _leaves(st):
    return [x.cpu().numpy() for x in parallel.tree_leaves(st)]


@pytest.mark.gpu
def test_engine_on_the_card_equals_the_cpu_tick_by_tick(cuda):
    L, n = 2, CFG.n_slots
    sts = {d: engine.init(CFG, lanes=L, device=d) for d in ("cpu", cuda)}
    rng = np.random.default_rng(4)
    stalls = retired = 0
    for tick in range(120):
        blocks = torch.from_numpy(np.where(
            rng.random((L, n)) < 0.3, rng.integers(1, 8, (L, n)), 0
        ).astype(np.int32))
        live = sts["cpu"].slot_live.numpy()
        mask = torch.from_numpy((rng.random((L, n)) < 0.2) & live)
        outs = {}
        for d, st in sts.items():
            st, oks = engine.admit_where(st, blocks.to(d))
            st, phys, src = engine.decode_translate(st, CFG)
            st, n_inval = engine.retire_where(st, mask.to(d))
            outs[d] = [x.cpu().numpy() for x in (oks, phys, src, n_inval)]
        for a, b in zip(outs["cpu"], outs[cuda]):
            assert np.array_equal(a, b), tick
        for i, (a, b) in enumerate(zip(_leaves(sts["cpu"]),
                                       _leaves(sts[cuda]))):
            assert a.dtype == b.dtype and np.array_equal(a, b), (tick, i)
        retired += int(mask.sum())
    stalls = int(sts["cpu"].n_pool_stall.sum())
    assert stalls > 0 and retired > 0


@pytest.mark.gpu
def test_run_load_on_the_card_equals_the_cpu(cuda, tmp_path):
    obs.configure(str(tmp_path / "trace.jsonl"))
    try:
        reqs = load.poisson_trace(3.0, 40, CFG, seed=9)
        recs = [load.run_load(reqs, CFG, lanes=2, run="gpu_t", rate=3.0,
                              device=d) for d in ("cpu", cuda)]
    finally:
        obs.configure()
    untimed = [{k: v for k, v in r.items()
                if k not in load.TIMING_FIELDS + ("trace_file",)}
               for r in recs]
    assert untimed[0] == untimed[1]
    assert recs[1]["retired"] == len(reqs)


@pytest.mark.gpu
@pytest.mark.parametrize("system,t", [("radix", 4), ("victima", 3)])
def test_time_sharded_kernel_run_equals_serial(cuda, system, t):
    cfg = systems.get(system).config(SimConfig(**TINY))
    tr = {k: v[:, 0] for k, v in workload_traces(["bc"], 1200).items()}
    serial, serial_ex = mmu.simulate(cfg, tr, device=cuda)
    before = mmu_step.LAUNCHES
    got, got_ex = mmu.simulate(cfg, tr, device=cuda, time_shards=t)
    rounds = mmu_step.LAUNCHES - before
    assert 1 <= rounds <= t
    for f, a, b in zip(serial._fields, serial, got):
        assert np.array_equal(np.asarray(a), np.asarray(b)), f
    assert serial_ex["l2_access"] == got_ex["l2_access"]
