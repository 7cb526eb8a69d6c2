"""The port's MMU simulator (``repro_torch``) against the JAX package.

Inputs are made once with numpy and handed to both sides; JAX runs on
the CPU and the port runs its plain PyTorch path on the CPU.  Every
comparison is exact: the simulator's state is integer, and its float32
sums are built in the reference's per-access order.

The reference's ladder path (``simulate_systems``) does not run on this
tree's jax (ROADMAP.md Queue 3), so the checks go through
``mmu.simulate``, ``mmu.simulate_batch`` and the golden snapshot.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_trace import GOLDEN_CFG, GOLDEN_SYSTEMS, golden_trace
from repro.core import mmu as j_mmu
from repro.core.stages import base as j_base
from repro.sim import systems as j_systems
from repro.sim import trace_gen as j_trace_gen
from repro_torch import obs as t_obs
from repro_torch.core import caches as t_caches
from repro_torch.core import mmu as t_mmu
from repro_torch.core.stages import base as t_base
from repro_torch.data.pipeline import _NO_CAP as T_NO_CAP
from repro_torch.sim import runner as t_runner
from repro_torch.sim import systems as t_systems
from repro_torch.sim import trace_gen as t_trace_gen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(ROOT, "tests", "golden", "mmu_stats.json")


def port_cfg(cfg) -> t_base.SimConfig:
    """The port's SimConfig with every field of a reference config."""
    vals = {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(j_base.SimConfig)}
    vals["lat"] = t_caches.Lat(*cfg.lat)
    return t_base.SimConfig(**vals)


def workload_trace(name: str, n: int, seed: int = 0) -> dict:
    g = j_trace_gen.generate(name, n=n, seed=seed)
    tr = dict(g["trace"])
    tr["ipa"] = np.full((n,), g["spec"].ipa, np.float32)
    return tr


def assert_stats_equal(ref, got, what):
    assert ref._fields == got._fields
    for f, a, b in zip(ref._fields, ref, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, f, a, b)


def assert_extras_equal(ref, got, what):
    assert sorted(ref) == sorted(got), what
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]), np.asarray(got[k])), \
            (what, k)


# ------------------------------------------------------------ types

def test_config_stats_and_state_mirror_the_reference():
    """SimConfig fields and defaults, Stats fields, and every MMUState
    leaf's shape and dtype equal the reference's, one for one."""
    jf = [(f.name, f.default) for f in dataclasses.fields(j_base.SimConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(t_base.SimConfig)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (n, a), (_, b) in zip(jf, tf):
        assert (tuple(a) if n == "lat" else a) == \
            (tuple(b) if n == "lat" else b), n
    assert j_base.Stats._fields == t_base.Stats._fields
    for cfg in (GOLDEN_CFG, j_base.SimConfig(),
                j_systems.config("victima_l2_8m"),
                j_systems.config("l3tlb_64k_15"),
                j_systems.config("pom_virt"), j_systems.config("isp")):
        ref = jax.tree.leaves(j_base.make_state(cfg))
        got = t_base.state_leaves(t_base.make_state(port_cfg(cfg)))
        assert [(x.shape, np.dtype(x.dtype)) for x in ref] == \
            [(tuple(x.shape[1:]), x.numpy().dtype) for x in got]


# the multicore fields, each set as the multicore systems set it
MULTICORE_FIELDS = {"dram_cache_sets": 2048, "n_cores": 2,
                    "shared_tier_stats": True}


@pytest.mark.parametrize("field", sorted(MULTICORE_FIELDS))
def test_config_takes_the_multicore_fields(field):
    """Each multicore field is accepted, and the config's stages and its
    state's leaves (the DRAM cache sized by ``dram_cache_sets``) mirror
    the reference's."""
    over = {field: MULTICORE_FIELDS[field]}
    got, want = t_base.SimConfig(**over), j_base.SimConfig(**over)
    assert getattr(got, field) == MULTICORE_FIELDS[field]
    assert t_base.dramc_of(got) == (field == "dram_cache_sets" or None)
    ref = jax.tree.leaves(j_base.make_state(want))
    leaves = t_base.state_leaves(t_base.make_state(got))
    assert [(x.shape, np.dtype(x.dtype)) for x in ref] == \
        [(tuple(x.shape[1:]), x.numpy().dtype) for x in leaves]


def test_registry_mirrors_the_reference():
    """Each reference system is registered with the same composition and
    overrides, in the reference's order."""
    for name in j_systems.names():
        ref = j_systems.get(name)
        got = t_systems.get(name)
        assert (got.stages, got.overrides) == (ref.stages, ref.overrides)
        assert dataclasses.astuple(port_cfg(ref.config())) == \
            dataclasses.astuple(got.config())
    assert t_systems.names() == j_systems.names()
    assert len(t_systems.REGISTRY) == 49
    with pytest.raises(KeyError, match="unknown system"):
        t_systems.get("no_such_system")


def test_trace_gen_copy_matches_reference():
    for name in j_trace_gen.all_workloads():
        a = j_trace_gen.generate(name, n=3000, seed=3)
        b = t_trace_gen.generate(name, n=3000, seed=3)
        assert dataclasses.astuple(a["spec"]) == dataclasses.astuple(
            b["spec"])
        assert (a["n_pages"], a["n_pages_2m_region"]) == \
            (b["n_pages"], b["n_pages_2m_region"])
        for k in a["trace"]:
            assert np.array_equal(a["trace"][k], b["trace"][k]), (name, k)


@pytest.mark.parametrize("seed", [0, 7, 3_000_003_201])
def test_trace_gen_matches_reference_at_full_length(seed):
    """Every workload at the benchmark's 150,000 accesses, where the Zipf
    sampler's near-tie band holds thousands of trials a trace, byte for
    byte the reference's (``rng.zipf`` itself)."""
    for name in j_trace_gen.all_workloads():
        a = j_trace_gen.generate(name, n=150_000, seed=seed)["trace"]
        b = t_trace_gen.generate(name, n=150_000, seed=seed)["trace"]
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), (name, k)


# the traces' exponents (zipf_a + 1e-9) at their page counts (1,572,864;
# dlrm's 2,700,083), and the data pipeline's draw (a = 1.3, no cap); the
# last case starts with half of a 64-bit draw held back by the generator
ZIPF_CASES = [(1.02, 1 << 21, 40_000), (1.12, 1 << 23, 40_000),
              (2.0, 1000, 40_000), (1.0001, 1 << 30, 5000)] + [
    (a + 1e-9, 1_572_864, 150_000) for a in (1.02, 1.05, 1.08, 1.10, 1.12)
] + [(1.05 + 1e-9, 2_700_083, 150_000), (1.3, T_NO_CAP, 150_000),
     (1.02 + 1e-9, 1_572_864, 20_000, True)]


def zipf_rng(seed: int, held: bool = False):
    rng = np.random.default_rng(seed)
    if held:
        rng.integers(1 << 20, dtype=np.uint32)
    return rng


def scalar_zipf(seed: int, a: float, n: int, cap,
                held: bool = False) -> tuple[list, object]:
    """numpy 2.0's Zipf sampler one trial at a time (``_zipf_trial``, C's
    pow): the `n` samples clipped to `cap`, and the generator after."""
    am1, b = a - 1.0, 2.0 ** (a - 1.0)
    rng = zipf_rng(seed, held)
    want = []
    while len(want) < n:
        x = t_trace_gen._zipf_trial(rng.random(), rng.random(), am1, b)
        if x > 0.0:
            want.append(min(int(x), cap))
    return want, rng


@pytest.mark.parametrize("a,cap,n,held", [
    pytest.param(a, cap, n, any(held), id=f"{a}-{cap}" + "-held" * any(held))
    for a, cap, n, *held in ZIPF_CASES])
def test_zipf_rounds_equal_the_scalar_sampler(a, cap, n, held):
    """The vectorised Zipf rounds give numpy 2.0's sampler trial by trial
    (``_zipf_trial``, C's pow) and leave the generator where it does,
    the half of a draw it may hold back included."""
    want, r1 = scalar_zipf(11, a, n, cap, held)
    r2 = zipf_rng(11, held)
    got = t_trace_gen._zipf(r2, a, n, cap)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert r1.bit_generator.state == r2.bit_generator.state
    assert r1.random() == r2.random()


@pytest.mark.parametrize("extended", [False, True])
def test_zipf_band_counters_and_fallback(extended, monkeypatch):
    """With the long double's precision probe forced under 63 bits every
    band trial takes the scalar path, with the same samples; on the real
    probe (x86-64's 63) most are decided vectorised.
    ``trace_gen.zipf_band`` and ``zipf_scalar`` count the two."""
    if not extended:
        monkeypatch.setattr(t_trace_gen, "_EXTENDED", False)
    a, cap, n = 1.05 + 1e-9, 1_572_864, 150_000
    band, scalar = t_obs.names.PORT_COUNTER_NAMES
    before = [t_obs.REGISTRY.counter(k) for k in (band, scalar)]
    r2 = np.random.default_rng(5)
    got = t_trace_gen._zipf(r2, a, n, cap)
    n_band, n_scalar = [t_obs.REGISTRY.counter(k) - b0
                        for k, b0 in zip((band, scalar), before)]
    want, r1 = scalar_zipf(5, a, n, cap)
    assert np.array_equal(got, want) and r1.random() == r2.random()
    assert n_band > 0
    if extended:
        assert 0 <= n_scalar < n_band
    else:
        assert n_scalar == n_band


# ------------------------------------------------------- simulation

@pytest.mark.parametrize("name", sorted(GOLDEN_SYSTEMS))
def test_golden_snapshot(name):
    """The port reproduces tests/golden/mmu_stats.json bit for bit."""
    with open(GOLDEN_PATH) as f:
        snap = json.load(f)[name]
    cfg = port_cfg(dataclasses.replace(GOLDEN_CFG, **GOLDEN_SYSTEMS[name]))
    stats, _ = t_mmu.simulate(cfg, golden_trace(), device="cpu")
    for field, want in snap.items():
        assert np.asarray(getattr(stats, field)).tolist() == want, field


@pytest.mark.parametrize("system", ["radix", "victima"])
def test_simulate_matches_reference_at_table3(system):
    """Table-3 defaults on `rnd`: every Stats leaf and the extras."""
    cfg = j_systems.config(system)
    tr = workload_trace("rnd", 2000)
    ref, rex = j_mmu.simulate(cfg, {k: jnp.asarray(v) for k, v in
                                    tr.items()})
    got, gex = t_mmu.simulate(port_cfg(cfg), tr, device="cpu")
    assert_stats_equal(ref, got, system)
    assert_extras_equal(rex, gex, system)


def test_simulate_batch_matches_reference():
    cfg = j_systems.config("victima")
    trs = [workload_trace(w, 800) for w in ("bc", "xs")]
    traces = {k: np.stack([t[k] for t in trs], axis=1) for k in trs[0]}
    ref, rex = j_mmu.simulate_batch(
        cfg, {k: jnp.asarray(v) for k, v in traces.items()})
    got, gex = t_mmu.simulate_batch(port_cfg(cfg), traces, device="cpu")
    for i in range(2):
        assert_stats_equal(ref[i], got[i], i)
        assert_extras_equal(rex[i], gex[i], i)


def test_carried_state_continues_the_reference_run():
    """Run the reference step under lax.scan, carry its state across,
    run on both sides and compare every leaf."""
    cfg = j_systems.config("victima")
    tr = workload_trace("bc", 2000, seed=5)
    half = {k: (v[:1000], v[1000:]) for k, v in tr.items()}
    step = j_mmu.make_step(cfg)
    scan = jax.jit(lambda st, t: jax.lax.scan(step, st, t)[0])
    mid = scan(j_base.make_state(cfg),
               {k: jnp.asarray(v[0]) for k, v in half.items()})
    end = scan(mid, {k: jnp.asarray(v[1]) for k, v in half.items()})

    tcfg = port_cfg(cfg)
    st = t_base.state_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(mid)], tcfg)
    step_t = t_mmu.make_step(tcfg)
    st = t_mmu.scan_accesses(
        step_t, st, {k: torch.from_numpy(v[1].copy())[:, None]
                     for k, v in half.items()},
        tcfg, ("l1_tlb", "l2_tlb", "victima", "ptw"))
    want = jax.tree.leaves(end)
    got = t_base.state_to_numpy(st)
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and np.array_equal(a, b[0]), i


def test_state_from_numpy_checks_leaves():
    tcfg = port_cfg(GOLDEN_CFG)
    leaves = t_base.state_to_numpy(t_base.make_state(tcfg, lanes=2))
    again = t_base.state_to_numpy(t_base.state_from_numpy(leaves, tcfg))
    assert all(np.array_equal(a, b) for a, b in zip(leaves, again))
    leaves[3] = leaves[3].astype(np.int64)
    with pytest.raises(ValueError, match="state leaf 3"):
        t_base.state_from_numpy(leaves, tcfg)


# ---------------------------------------------------------- drivers

def test_runner_caches_and_batches_consistently(tmp_path, monkeypatch):
    """run_batch fills the port's cache; run reads the same entry, and a
    fresh single run equals the batched lane."""
    monkeypatch.setattr(t_runner, "CACHE_DIR", str(tmp_path))
    out = t_runner.run_batch("victima", ["bc", "rnd"], n=300, device="cpu")
    assert len(list(tmp_path.glob("*.pkl"))) == 2
    again = t_runner.run("victima", "rnd", n=300, device="cpu")
    assert_stats_equal(out["rnd"][0], again[0], "cached")
    fresh = t_runner.run("victima", "rnd", n=300, device="cpu", cache=False)
    assert_stats_equal(out["rnd"][0], fresh[0], "fresh")
    assert_extras_equal(out["rnd"][1], fresh[1], "fresh")


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_cfg(GOLDEN_CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mmu.simulate(cfg, golden_trace(n=10))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_runner.run("radix", "rnd", n=10, cache=False)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core.mmu, repro_torch.core.metrics,"
        " repro_torch.core.timing, repro_torch.sim.runner,"
        " repro_torch.sim.systems, repro_torch.kernels.mmu_step,"
        " repro_torch.kernels.build, repro_torch.models.model,"
        " repro_torch.sim.sweep\n"
        "import chip_smoke\n"
        "import runpy; runpy.run_path('examples/quickstart_torch.py')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
