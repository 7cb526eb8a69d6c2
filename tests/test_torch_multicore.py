"""The port's multicore shared tier (``repro_torch``) against the JAX
package, on the CPU: mixes, the DRAM cache's probe, the contention term,
the runner's multicore cells and ``multicore_scaling``.

- ``parse_mix`` and ``generate_mix`` equal the reference's (every leaf
  byte for byte; lane c is ``generate(names[c % k], n, seed + 7919 c)``);
- ``_dramc_probe``, ``access_data`` and ``access_pte`` with the DRAM-cache
  gate absent, on and off, on seeded lane-batched rows (as
  tests/test_torch_primitives.py), against the reference under ``vmap``;
- the contention term splits two lanes of one workload;
- ``run``, ``run_batch`` and ``run_ladder`` write byte-identical cache
  entries for a multicore system;
- ``multicore_scaling``'s rows equal ``benchmarks/paper.py``'s on shared
  seeded synthetic results, ``_mc_sys`` patched alike on both sides.

The systems themselves (every ``*_{1,2,4}c`` system's core lanes, the
multicore ladder's lanes) are held against the reference in
tests/test_torch_multicore_systems.py.
"""
import dataclasses
import zlib

import numpy as np
import pytest

from golden_trace import GOLDEN_CFG
from repro.core import caches as j_caches
from repro.core.stages import base as j_base
from repro.sim import trace_gen as j_trace_gen
from repro_torch.core import caches as t_caches
from repro_torch.core import mmu as t_mmu
from repro_torch.core.stages import base as t_base
from repro_torch.sim import paper as t_paper
from repro_torch.sim import runner as t_runner
from repro_torch.sim import systems as t_systems
from repro_torch.sim import trace_gen as t_trace_gen
from test_torch_mmu import port_cfg
from test_torch_paper import reference_paper, synthetic
from test_torch_primitives import (LINES, W, assert_same, bools, i32,
                                   r_assoc, r_hier, t, to_jax, to_port, vjit)

# ------------------------------------------------------------ mixes


@pytest.mark.parametrize("spec", ["bc+rnd+xs", "bc", " bc + rnd ",
                                  "bc+bogus", "bc++rnd", "nope+zz+bc"])
def test_parse_mix_is_the_reference_s(spec):
    def outcome(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(t_trace_gen.parse_mix) == \
        outcome(j_trace_gen.parse_mix)
    assert t_trace_gen.MIX_SEED_SKEW == j_trace_gen.MIX_SEED_SKEW


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("cores", [1, 2, 4])
@pytest.mark.parametrize("spec", ["bc+rnd+xs", "bc+bc"])
def test_generate_mix_is_the_reference_s(spec, cores, seed):
    n = 300
    a = j_trace_gen.generate_mix(spec, n=n, seed=seed, n_cores=cores)
    b = t_trace_gen.generate_mix(spec, n=n, seed=seed, n_cores=cores)
    assert sorted(a["trace"]) == sorted(b["trace"]) == \
        ["core", "ipa", "is2m", "line", "vpn"]
    for k in a["trace"]:
        x, y = np.asarray(a["trace"][k]), np.asarray(b["trace"][k])
        assert x.dtype == y.dtype and x.shape == y.shape == (n, cores)
        assert x.tobytes() == y.tobytes(), k
    assert [dataclasses.astuple(s) for s in a["spec"]] == \
        [dataclasses.astuple(s) for s in b["spec"]]
    assert (a["n_pages"], a["n_pages_2m_region"]) == \
        (b["n_pages"], b["n_pages_2m_region"])
    names = t_trace_gen.parse_mix(spec)
    for c in range(cores):  # the round-robin-with-skew arbiter
        g = t_trace_gen.generate(names[c % len(names)], n=n,
                                 seed=seed + t_trace_gen.MIX_SEED_SKEW * c)
        for k, v in g["trace"].items():
            assert np.array_equal(b["trace"][k][:, c], v), (c, k)
        assert np.all(b["trace"]["core"][:, c] == c)


# -------------------------------------------------- the DRAM cache


def _hier(rng):
    """A seeded hierarchy whose DRAM cache has 8 sets, so a probe can
    hit or miss."""
    return r_hier(rng)._replace(dramc=r_assoc(rng, 8, 16, LINES, 4))


def _gate(dramc):
    return {"none": None, "on": True, "off": False}[dramc]


@pytest.mark.parametrize("dramc", ["none", "on", "off"])
def test_dramc_probe_is_the_reference_s(dramc):
    for seed in range(3):
        rng = np.random.default_rng(seed)
        h = _hier(rng)
        line = rng.choice(LINES, W).astype(np.int32)
        miss3 = bools(rng, (W,), 0.7)
        rh, rcyc, rdram = vjit(j_caches._dramc_probe, lat=j_caches.Lat(),
                               dramc=_gate(dramc))(to_jax(h), line, miss3)
        th = to_port(h)
        cyc, dram = t_caches._dramc_probe(th, t(line), t(miss3),
                                          t_caches.Lat(), _gate(dramc))
        assert_same(rh, th)
        assert np.array_equal(np.asarray(rcyc), np.broadcast_to(
            np.asarray(cyc), (W,)))
        assert np.array_equal(np.asarray(rdram), dram.numpy())


@pytest.mark.parametrize("dramc", ["none", "on", "off"])
def test_access_data_with_a_dram_cache_is_the_reference_s(dramc):
    for seed in range(3):
        rng = np.random.default_rng(100 + seed)
        h = _hier(rng)
        line = rng.choice(LINES, W).astype(np.int32)
        now, pressure = i32(rng, 0, 2**31 - 1, (W,)), bools(rng, (W,))
        ref = vjit(j_caches.access_data, tlb_aware=True, lat=j_caches.Lat(),
                   geom=None, dramc=_gate(dramc))(to_jax(h), line, now,
                                                  pressure)
        got = t_caches.access_data(to_port(h), t(line), t(now), t(pressure),
                                   True, t_caches.Lat(), None, _gate(dramc))
        assert_same(ref, got)


@pytest.mark.parametrize("dramc", ["none", "on", "off"])
def test_access_pte_with_a_dram_cache_is_the_reference_s(dramc):
    for seed in range(3):
        rng = np.random.default_rng(200 + seed)
        h = _hier(rng)
        line = rng.choice(LINES, W).astype(np.int32)
        pressure, en = bools(rng, (W,)), bools(rng, (W,), 0.8)
        ref = vjit(j_caches.access_pte, tlb_aware=True, lat=j_caches.Lat(),
                   bt=j_caches.BT_TLB4, dramc=_gate(dramc))(
            to_jax(h), line, pressure, enable=en)
        got = t_caches.access_pte(to_port(h), t(line), t(pressure), True,
                                  t_caches.Lat(), t(en), t_caches.BT_TLB4,
                                  None, _gate(dramc))
        assert_same(ref, got)


def test_dramc_gate_follows_the_config_and_the_lane():
    cfg = t_systems.config("victima_dramc_2c")
    assert t_base.dramc_of(cfg) is True
    assert t_base.dramc_of(t_systems.config("victima_2c")) is None
    dyn = t_systems.ladder_dyn(t_systems.LADDERS["radix_2c"])
    assert t_base.dramc_of(cfg, dyn).tolist() == [False, False, False, True]
    st = t_base.make_state(cfg)
    assert tuple(st.hier.dramc.tags.shape) == (1, 2048, 16)


# ------------------------------------------------ the contention term


def test_contention_splits_two_lanes_of_one_workload():
    """Two cores running the same workload (``bc+bc``; their streams are
    skewed, so the L2-TLB misses differ too) wait different arbitration
    slots: the lanes' translation cycles differ, and at one core the
    term is gone."""
    cfg = port_cfg(dataclasses.replace(GOLDEN_CFG, n_cores=2))
    g = t_trace_gen.generate_mix("bc+bc", n=400, seed=3, n_cores=2)
    per, _ = t_mmu.simulate_batch(cfg, g["trace"], device="cpu")
    a, b = (float(p.sum_trans_cyc) for p in per)
    assert a != b
    # the same lane without the term: fewer cycles, the same walks (no
    # state depends on the slots waited)
    one = dataclasses.replace(cfg, n_cores=1)
    lane0 = {k: v[:, :1] for k, v in g["trace"].items()}
    solo, _ = t_mmu.simulate_batch(one, lane0, device="cpu")
    assert float(solo[0].sum_trans_cyc) < a
    assert int(solo[0].n_demand_ptw) == int(per[0].n_demand_ptw)


# -------------------------------------------------- the runner's cells


def test_multicore_cells_are_byte_identical_by_every_path(tmp_path,
                                                          monkeypatch):
    """``run``, ``run_batch`` and ``run_ladder`` store the same bytes for
    a multicore system on a mix (and, at one core, on a workload); the
    cell is a per-core tuple."""
    n, seed = 16, 2
    paths = {}
    for how in ("run", "batch", "ladder"):
        monkeypatch.setattr(t_runner, "CACHE_DIR", str(tmp_path / how))
        for system, wl in (("victima_dramc_2c", "bc+rnd"),
                           ("victima_dramc_1c", "bc")):
            if how == "run":
                out = t_runner.run(system, wl, n=n, seed=seed, device="cpu")
            elif how == "batch":
                out = t_runner.run_batch(system, [wl], n=n, seed=seed,
                                         device="cpu")[wl]
            else:
                ladder = "radix_" + system.rsplit("_", 1)[1]
                out = t_runner.run_ladder(
                    ladder, workloads=[wl], n=n, seed=seed,
                    members=(system,), device="cpu")[system][wl]
            stats, extras, spec = out
            cores = t_systems.config(system).n_cores
            if cores > 1:
                assert len(stats) == len(extras) == len(spec) == cores
                assert all(e["dramc_access"] > 0 for e in extras)
            else:
                assert stats._fields == t_base.Stats._fields
            key = t_runner._key(system, wl, n, seed, None) + ".pkl"
            paths.setdefault((system, wl), []).append(
                (tmp_path / how / key).read_bytes())
    for cell, blobs in paths.items():
        assert blobs[0] == blobs[1] == blobs[2], cell


# ------------------------------------------------- multicore_scaling


def _shared_extras(system: str, core: int, ex: dict) -> dict:
    rng = np.random.default_rng(zlib.crc32(f"{system}/{core}".encode()))
    acc = int(rng.integers(1000, 9000))
    dacc = int(rng.integers(0, acc)) if "dramc" in system else 0
    return {**ex, "l3_access": acc, "l3_trans": int(rng.integers(0, acc)),
            "dramc_access": dacc,
            "dramc_hit": int(rng.integers(0, dacc + 1))}


def mc_result(pkg: str, system: str, workload: str):
    """A seeded synthetic multicore result, as package `pkg` ("ref" or
    "port") would give it: per-core tuples above one core, a plain
    single-core result at one."""
    stats_t, tg = ((j_base.Stats, j_trace_gen) if pkg == "ref"
                   else (t_base.Stats, t_trace_gen))
    cores = t_systems.config(system).n_cores
    names = tg.parse_mix(workload)
    lanes = []
    for c in range(cores):
        s = synthetic(system, f"{workload}/{c}")
        lanes.append((stats_t(**s["stats"]),
                      _shared_extras(system, c, s["extras"]),
                      tg.WORKLOADS[names[c % len(names)]]))
    if cores == 1:
        return lanes[0]
    return tuple(tuple(x[i] for x in lanes) for i in range(3))


@pytest.mark.parametrize("mix", ["bc+rnd+xs", "xs+bc"])
def test_multicore_scaling_rows_are_the_reference_s(mix, monkeypatch):
    paper = reference_paper()
    assert t_paper.MC_MIX == paper.MC_MIX == "bc+rnd+xs"
    monkeypatch.setattr(paper, "MC_MIX", mix)
    monkeypatch.setattr(paper, "_mc_sys", lambda name, wl: (
        mc_result("ref", name, wl), 0.0))
    want = [(r[0], r[2]) for r in paper.multicore_scaling()]
    monkeypatch.setattr(t_paper, "MC_MIX", mix)
    fetched = []

    def mc_sys(self, name, wl):
        fetched.append((name, wl))
        return mc_result("port", name, wl), 0.0

    monkeypatch.setattr(t_paper.Run, "mc_sys", mc_sys)
    rows = t_paper.multicore_scaling(n=20_000, device="cpu")
    assert [(r[0], r[2]) for r in rows] == want
    assert all(isinstance(r[1], float) and r[1] >= 0 for r in rows)
    first = mix.split("+")[0]
    assert [w for _, w in fetched] == [first] * 4 + [mix] * 8


def test_lanes_normalizes_as_the_reference():
    single = mc_result("port", "radix_1c", "bc")
    multi = mc_result("port", "radix_2c", "bc+rnd")
    paper = reference_paper()
    for r in (single, multi):
        got, want = t_paper._lanes(r), paper._lanes(r)
        assert [len(x) for x in got] == [len(x) for x in want]
        assert got[1] == want[1]
    assert len(t_paper._lanes(single)[0]) == 1
    assert len(t_paper._lanes(multi)[0]) == 2
