"""The port's ``sim.parallel`` (mesh planning, lane and system splits,
time sharding) and its threading through ``core.mmu`` against the JAX
package.

- ``plan_mesh`` (forced meshes and every error included),
  ``pick_t_shards`` and ``plan_lane_dim`` equal the reference's over a
  grid of (S, W, C, devices);
- ``time_shard_scan`` on the reference's toy fold
  (tests/test_mmu_kernel.py), over the same (t, batch) cases, with the
  same rounds;
- the port's plain ``simulate(..., time_shards=t)`` equals its serial
  run and the reference's time-sharded run, every Stats leaf, with the
  same hand-off rounds (read from each package's trace events);
- ``simulate_systems`` split over two and four ``cpu`` devices equals
  the single-device run and each system's own ``simulate_batch``;
  ``shard_lanes`` splits and gathers lanes in order.

The reference's own ``shard_systems`` and ``simulate_systems`` do not run
under this tree's jax (ROADMAP.md Queue 3), so the port's split is held
against the port's per-system runs, as for the ladders.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as j_obs
import repro_torch.obs as t_obs
from golden_trace import GOLDEN_CFG, golden_trace
from repro.core import mmu as j_mmu
from repro.sim import parallel as j_par
from repro_torch.core import mmu as t_mmu
from repro_torch.core.stages import base as t_base
from repro_torch.sim import parallel as t_par
from repro_torch.sim import systems as t_systems
from test_torch_mmu import assert_extras_equal, assert_stats_equal, port_cfg

CPU = torch.device("cpu")


def _outcome(fn, *args, **kw):
    """A call's result, or its error's type and message."""
    try:
        r = fn(*args, **kw)
    except Exception as e:  # the reference's error is the expectation
        return ("raises", type(e).__name__, str(e))
    return dataclasses.asdict(r) if dataclasses.is_dataclass(r) else r


# ------------------------------------------------------- pure arithmetic

FORCES = [None, (1, 1), (2, 2), (3, 2), (4, 1), (2, 1, 2), (1, 1, 4),
          (2, 2, 3), (0, 2), (2, 0), (1, 1, 0), (1,), (1, 2, 3, 4)]


@pytest.mark.parametrize("n_cores", [0, 1, 2, 4])
def test_plan_mesh_is_the_reference_s(n_cores):
    for S, W, d, force in itertools.product(
            (0, 1, 2, 3, 5, 28), (0, 1, 2, 3, 4, 11), (1, 2, 3, 4, 6, 8),
            FORCES):
        want = _outcome(j_par.plan_mesh, S, W, n_devices=d, force=force,
                        n_cores=n_cores)
        got = _outcome(t_par.plan_mesh, S, W, n_devices=d, force=force,
                       n_cores=n_cores)
        assert got == want, (S, W, d, force, n_cores)
        if isinstance(want, dict):
            jp = j_par.plan_mesh(S, W, n_devices=d, force=force,
                                 n_cores=n_cores)
            tp = t_par.plan_mesh(S, W, n_devices=d, force=force,
                                 n_cores=n_cores)
            assert (tp.n_devices, tp.describe()) == \
                (jp.n_devices, jp.describe())


def test_pick_t_shards_and_plan_lane_dim_are_the_reference_s():
    for n, req in itertools.product(range(-1, 31), range(-1, 9)):
        assert _outcome(t_par.pick_t_shards, n, req) == \
            _outcome(j_par.pick_t_shards, n, req), (n, req)
    for lanes, d in itertools.product(range(-1, 9), range(-1, 7)):
        assert _outcome(t_par.plan_lane_dim, lanes, n_devices=d) == \
            _outcome(j_par.plan_lane_dim, lanes, n_devices=d), (lanes, d)
    # the default count: the visible cards, or the CPU alone
    assert t_par.local_device_count() == max(torch.cuda.device_count(), 1)
    assert t_par.plan_lane_dim(4) == t_par.plan_lane_dim(
        4, n_devices=t_par.local_device_count())


def test_build_mesh_rejects_oversized_plans():
    plan = t_par.plan_mesh(28, 11, n_devices=4, force=(4, 1))
    with pytest.raises(ValueError, match="needs 4 devices but only 2"):
        t_par.build_mesh(plan, [CPU, CPU])
    grid = t_par.build_mesh(t_par.plan_mesh(4, 2, force=(2, 1, 2),
                                            n_cores=2), [CPU] * 4)
    assert (len(grid), len(grid[0]), len(grid[0][0])) == (2, 1, 2)


# ------------------------------------------------- time_shard_scan (toy)

def _j_toy_step(st, acc):
    """tests/test_mmu_kernel.py's order-dependent toy carry."""
    tab, tot = st
    idx = acc % tab.shape[0]
    tab = tab.at[idx].set(tab[idx] * 3 + acc)
    return (tab, tot + tab[idx]), ()


def _t_toy_block(st, tr):
    """The same fold over lane-batched state ([L, 5], [L]) and a [T, L]
    trace, in place."""
    tab, tot = st
    lane = torch.arange(tab.shape[0])
    for acc in tr:
        idx = (acc % tab.shape[1]).long()
        tab[lane, idx] = tab[lane, idx] * 3 + acc
        tot += tab[lane, idx]
    return (tab, tot)


def _rounds(events) -> int:
    return max((e["attrs"]["round"] for e in events
                if e.get("name") == "time_shard_round"), default=0)


@pytest.fixture
def traces_to(tmp_path):
    """Both packages' tracers pointed at fresh files for one test."""
    j = j_obs.configure(str(tmp_path / "ref.jsonl"))
    t = t_obs.configure(str(tmp_path / "port.jsonl"))
    yield j, t
    j_obs.configure()
    t_obs.configure()


def test_time_shard_scan_resolves_the_toy_fold(traces_to):
    j_tr, t_tr = traces_to
    tr = np.arange(60, dtype=np.int32)

    def block_fn(st, tr_blk):
        st, _ = jax.lax.scan(_j_toy_step, st, tr_blk)
        return st

    j_st0 = (jnp.zeros((4,), jnp.int32), jnp.int32(0))
    t_st0 = (torch.zeros((1, 4), dtype=torch.int32),
             torch.zeros((1,), dtype=torch.int32))
    t_tr_in = torch.from_numpy(tr)[:, None]
    serial = _t_toy_block((t_st0[0].clone(), t_st0[1].clone()), t_tr_in)
    for t, batch in [(4, "vmap"), (3, "map"), (1, "vmap"), (7, "vmap")]:
        n_j, n_t = len(j_tr.events), len(t_tr.events)
        want, winfo = j_par.time_shard_scan(block_fn, j_st0,
                                            jnp.asarray(tr), t, batch=batch)
        got, info = t_par.time_shard_scan(_t_toy_block, t_st0, t_tr_in, t,
                                          batch=batch)
        assert info == winfo, (t, batch)
        assert _rounds(t_tr.events[n_t:]) == _rounds(j_tr.events[n_j:])
        for a, b, c in zip(want, got, serial):
            assert np.array_equal(np.asarray(a), b[0].numpy()), (t, batch)
            assert torch.equal(b, c)
    # st0 is left as it was
    assert not t_st0[0].any() and not t_st0[1].any()
    with pytest.raises(ValueError, match="batch mode"):
        t_par.time_shard_scan(_t_toy_block, t_st0, t_tr_in, 2,
                              batch="pmap")


def test_time_shard_scan_on_several_lanes(traces_to):
    """Lanes stay independent: 3 lanes of different traces, 5 blocks."""
    rng = np.random.default_rng(3)
    tr = torch.from_numpy(rng.integers(0, 50, (40, 3), dtype=np.int32))
    st0 = (torch.zeros((3, 4), dtype=torch.int32),
           torch.zeros((3,), dtype=torch.int32))
    serial = _t_toy_block((st0[0].clone(), st0[1].clone()), tr)
    got, info = t_par.time_shard_scan(_t_toy_block, st0, tr, 5)
    assert info["t_shards"] == 5 and 1 <= info["rounds"] <= 5
    for a, b in zip(serial, got):
        assert torch.equal(a, b)


# ------------------------------------------- time-sharded simulate (mmu)

def test_time_sharded_simulate_equals_serial_and_the_reference(traces_to):
    j_tr, t_tr = traces_to
    tr = golden_trace(n=256)
    cfg = port_cfg(GOLDEN_CFG)
    serial, serial_ex = t_mmu.simulate(cfg, tr, device="cpu")
    for t in (2, 4):
        n_j, n_t = len(j_tr.events), len(t_tr.events)
        want, _ = j_mmu.simulate(GOLDEN_CFG,
                                 {k: jnp.asarray(v) for k, v in tr.items()},
                                 time_shards=t)
        got, got_ex = t_mmu.simulate(cfg, tr, device="cpu", time_shards=t)
        assert_stats_equal(serial, got, ("serial", t))
        assert_extras_equal(serial_ex, got_ex, ("serial", t))
        assert_stats_equal(jax.device_get(want), got, ("reference", t))
        rounds = _rounds(t_tr.events[n_t:])
        assert rounds == _rounds(j_tr.events[n_j:]) and 1 <= rounds <= t


# --------------------------------------- the system and workload splits

_VARIANTS = [
    dict(l2tlb_sets=8, l2tlb_ways=4),
    dict(l2tlb_sets=16, l2tlb_ways=4, victima=True),
    dict(l2tlb_sets=16, l2tlb_ways=8, l2tlb_lat=17),
]


@pytest.fixture(scope="module")
def family():
    cfgs = [port_cfg(dataclasses.replace(GOLDEN_CFG, **v))
            for v in _VARIANTS]
    base = t_systems.dyn_base_config(cfgs)
    dyns = t_base.stack_dyns([t_base.dyn_of(c) for c in cfgs])
    trs = [golden_trace(160, seed) for seed in (1, 2)]
    traces = {k: np.stack([tr[k] for tr in trs], axis=1) for k in trs[0]}
    per1, ex1 = t_mmu.simulate_systems(base, dyns, traces, device="cpu")
    return cfgs, base, dyns, traces, per1, ex1


@pytest.mark.parametrize("force", [(2, 1), (1, 2), (2, 2)])
def test_simulate_systems_split_over_cpu_devices(family, force):
    """3 systems (padded to 4 on a sys dim of 2) x 2 workloads, split
    over forced meshes of `cpu` devices: every lane equals the 1x1 run,
    which equals each system's own simulate_batch."""
    cfgs, base, dyns, traces, per1, ex1 = family
    plan = t_par.plan_mesh(3, 2, force=force)
    assert plan.n_devices > 1
    per, ex = t_mmu.simulate_systems(base, dyns, traces, device="cpu",
                                     plan=plan)
    for s, c in enumerate(cfgs):
        for w in range(2):
            assert_stats_equal(per1[s][w], per[s][w], (force, s, w))
            assert_extras_equal(ex1[s][w], ex[s][w], (force, s, w))
    if force == (2, 1):
        for s, c in enumerate(cfgs):
            want, want_ex = t_mmu.simulate_batch(c, traces, device="cpu")
            for w in range(2):
                assert_stats_equal(want[w], per1[s][w], (s, w))
                assert_extras_equal(want_ex[w], ex1[s][w], (s, w))


def test_time_sharded_systems_need_a_1x1_plan(family, traces_to):
    cfgs, base, dyns, traces, per1, _ = family
    run = t_mmu.make_systems_runner(base, device="cpu", time_shards=5)
    per, _ = run(dyns, traces)
    assert run.last_time_shard_info["t_shards"] == 5
    for s in range(3):
        for w in range(2):
            assert_stats_equal(per1[s][w], per[s][w], (s, w))
    plan = t_par.plan_mesh(3, 2, n_devices=2, force=(2, 1))
    with pytest.raises(ValueError, match="1x1"):
        t_mmu.make_systems_runner(base, device="cpu", plan=plan,
                                  time_shards=2)


def test_shard_systems_pads_and_slices_the_system_axis():
    calls = []

    def fn(d, tr):
        calls.append((tuple(d.shape), tuple(tr["x"].shape)))
        return (d[:, None] * 100 + tr["x"][0][None, :],)

    d = torch.arange(5)
    tr = {"x": torch.arange(12).reshape(2, 6)}
    plan = t_par.plan_mesh(5, 6, force=(2, 3))
    (out,) = t_par.shard_systems(fn, d, tr, plan, devices=[CPU] * 6)
    assert torch.equal(out, d[:, None] * 100 + tr["x"][0][None, :])
    assert calls == [((3,), (2, 2))] * 6
    with pytest.raises(ValueError, match="grid but the inputs"):
        t_par.shard_wrap(fn, plan, [CPU] * 6)(d[:4], tr)


def test_shard_lanes_splits_and_gathers_in_lane_order():
    seen = []

    def fn(x, y):
        seen.append(x.shape[0])
        return x * 2 + 1, (y.sum(1),)

    x = torch.arange(6, dtype=torch.int32).reshape(6, 1)
    y = np.ones((6, 3), np.int32)
    call = t_par.shard_lanes(fn, 6, devices=[CPU] * 4)
    assert call.mesh_dim == 3
    a, (b,) = call(x, torch.from_numpy(y))
    assert seen == [2, 2, 2]
    assert torch.equal(a.ravel(), torch.arange(6, dtype=torch.int32) * 2 + 1)
    assert torch.equal(b, torch.full((6,), 3))
    one = t_par.shard_lanes(fn, 6, n_devices=1)
    assert one.mesh_dim == 1 and torch.equal(one(x, torch.from_numpy(y))[0],
                                             a)
