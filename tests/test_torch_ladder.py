"""The port's ``Dyn`` ladders (``repro_torch``) against the JAX package,
on the CPU.

- (a) the dynamic views -- ``lookup_dyn``, ``insert_lru_dyn``, the SRRIP
  victims with ``way_ok``, and the L2 cache through an ``L2Geom`` --
  against the reference on seeded random rows;
- (b) ``DYN_FIELDS``, ``dyn_of``, the ladder base configs, ``ladder_dyn``
  and ``LADDERS`` against the reference's;
- (c) the dyn step: the port's ``make_step(base, dyn=...)`` against the
  reference's under a plain ``jax.lax.scan`` (the reference's
  ``simulate_systems`` does not run under the installed jax), for the
  variant sets of ``test_systems_registry``: every Stats leaf, extra and
  state leaf exact;
- (d) the port's ``simulate_systems`` S x W: each lane equals the port's
  per-system run;
- (e) ``auto_chunk`` against the reference's;
- (f) ``run_ladder``'s cache contract on tiny runs.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_trace import GOLDEN_CFG, golden_trace
from repro.core import assoc as j_assoc
from repro.core import caches as j_caches
from repro.core import mmu as j_mmu
from repro.core.stages import base as j_base
from repro.sim import runner as j_runner
from repro.sim import systems as j_systems
from repro_torch.core import assoc as t_assoc
from repro_torch.core import caches as t_caches
from repro_torch.core import mmu as t_mmu
from repro_torch.core.stages import base as t_base
from repro_torch.kernels import mmu_step
from repro_torch.sim import runner as t_runner
from repro_torch.sim import systems as t_systems
from test_torch_mmu import assert_extras_equal, assert_stats_equal, port_cfg
from test_torch_primitives import (W, assert_same, bools, i32, r_assoc,
                                   r_hier, r_l2, t, to_jax, to_port)

SEEDS = range(6)
# accesses of the dyn-step comparison: 1,000, as in
# tests/test_torch_nested.py -- the reference's compile of the nested
# family's step takes most of a case's time already
N = 1000

# ------------------------------------------------------- (a) the views


def _geom(rng, sets, ways):
    """A per-lane view geometry inside (sets, ways): set masks and way
    counts drawn from the powers of two below them."""
    set_masks = [s - 1 for s in (1, 2, 4, 8, 16) if s <= sets]
    way_counts = [w for w in (1, 2, 4, 8, 16) if w <= ways]
    return (rng.choice(set_masks, W).astype(np.int32),
            rng.choice(way_counts, W).astype(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_lookup_and_insert_lru_dyn(seed):
    rng = np.random.default_rng(seed)
    a = r_assoc(rng, 8, 8, np.arange(24), 6)  # few stamps: LRU ties
    mask, ways = _geom(rng, 8, 8)
    key, now = i32(rng, 0, 24, (W,)), i32(rng, 0, 2**31 - 1, (W,))
    en = bools(rng, (W,), 0.8)
    ref = jax.vmap(j_assoc.lookup_dyn)(to_jax(a), key, mask, ways)
    got = t_assoc.lookup_dyn(to_port(a), t(key), t(mask), t(ways))
    assert_same(ref[0], got[0])
    assert_same(ref[1:], got[1:], index=True)
    ref = jax.vmap(j_assoc.insert_lru_dyn)(to_jax(a), key, now, mask, ways,
                                           en)
    got = t_assoc.insert_lru_dyn(to_port(a), t(key), t(now), t(mask),
                                 t(ways), t(en))
    assert_same(ref, got)


@pytest.mark.parametrize("seed", SEEDS)
def test_srrip_victims_with_way_ok(seed):
    rng = np.random.default_rng(seed)
    rrpv, valid = i32(rng, 0, 4, (W, 16)), bools(rng, (W, 16), 0.85)
    is_tlb, pressure = bools(rng, (W, 16), 0.4), bools(rng, (W,))
    way_ok = np.arange(16)[None, :] < _geom(rng, 1, 16)[1][:, None]
    aged, v = jax.vmap(j_assoc.srrip_age_and_pick)(rrpv, valid, way_ok)
    taged, tv = t_assoc.srrip_age_and_pick(t(rrpv), t(valid), t(way_ok))
    assert_same(aged, taged)
    assert_same(v, tv, index=True)
    aged, v = jax.vmap(j_assoc.srrip_victim_tlb_aware)(rrpv, valid, is_tlb,
                                                      pressure, way_ok)
    taged, tv = t_assoc.srrip_victim_tlb_aware(t(rrpv), t(valid), t(is_tlb),
                                               t(pressure), t(way_ok))
    assert_same(aged, taged)
    assert_same(v, tv, index=True)


@functools.lru_cache(maxsize=None)
def _j_l2(fn, tlb_aware):
    if fn == "access_data":
        return jax.jit(jax.vmap(
            lambda h, line, now, p, g: j_caches.access_data(
                h, line, now, p, tlb_aware, j_caches.Lat(), g)))
    f = getattr(j_caches, fn)
    return jax.jit(jax.vmap(
        lambda c, k, b, p, e, g: f(c, k, b, p, tlb_aware, e, g)))


@pytest.mark.parametrize("tlb_aware", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_l2_cache_through_a_view(seed, tlb_aware):
    """l2_lookup, l2_insert, l2_retag_to_tlb and access_data with an
    L2Geom, per-lane block types."""
    rng = np.random.default_rng(seed)
    l2 = r_l2(rng, 8, 16, np.arange(40))
    geom = _geom(rng, 8, 16)
    jg, tg = j_caches.L2Geom(*geom), t_caches.L2Geom(*map(t, geom))
    key, bt = i32(rng, 0, 40, (W,)), i32(rng, 0, 4, (W,))
    pressure, en = bools(rng, (W,)), bools(rng, (W,), 0.8)
    ref = jax.vmap(j_caches.l2_lookup)(to_jax(l2), key, bt, jg)
    got = t_caches.l2_lookup(to_port(l2), t(key), t(bt), tg)
    assert_same(ref[0], got[0])
    assert_same(ref[1:], got[1:], index=True)
    for fn in ("l2_insert", "l2_retag_to_tlb"):
        ref = _j_l2(fn, tlb_aware)(to_jax(l2), key, bt, pressure, en, jg)
        got = getattr(t_caches, fn)(to_port(l2), t(key), t(bt), t(pressure),
                                    tlb_aware, t(en), tg)
        assert_same(ref, got)
    h = r_hier(rng)
    geom = _geom(rng, 8, 16)
    line = rng.choice(np.arange(64), W).astype(np.int32)
    now = i32(rng, 0, 2**31 - 1, (W,))
    ref = _j_l2("access_data", tlb_aware)(
        to_jax(h), line, now, pressure, j_caches.L2Geom(*geom))
    got = t_caches.access_data(to_port(h), t(line), t(now), t(pressure),
                               tlb_aware, t_caches.Lat(),
                               t_caches.L2Geom(*map(t, geom)))
    assert_same(ref, got)


# -------------------------------------------------- (b) the registry


def _fields(cfg):
    return {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(j_base.SimConfig) if f.name != "lat"}


def test_dyn_fields_and_gates_are_the_reference_s():
    assert t_base.DYN_FIELDS == j_base.DYN_FIELDS
    assert t_base.Dyn._fields == j_base.Dyn._fields
    assert t_systems.DYN_GATED_STAGES == j_systems.DYN_GATED_STAGES


@pytest.mark.parametrize("name", sorted(t_systems.REGISTRY))
def test_dyn_of_every_system_is_the_reference_s(name):
    got = t_base.dyn_of(t_systems.config(name))
    want = j_base.dyn_of(j_systems.config(name))
    for f, a, b in zip(got._fields, got, want):
        b = np.asarray(b)
        assert a.shape == (1,) and a.numpy().dtype == b.dtype, f
        assert a.item() == b.item(), (name, f)


def test_ladders_are_the_reference_s_restricted_to_the_port():
    """The port registers every reference system, so its ladders are the
    reference's five, members in the reference's order."""
    assert t_systems.LADDERS == j_systems.LADDERS
    assert list(t_systems.LADDERS) == ["radix", "np", "radix_1c",
                                       "radix_2c", "radix_4c"]
    assert len(t_systems.LADDERS["radix"]) == 28
    assert t_systems.LADDERS["np"] == ("np", "victima_virt", "pom_virt",
                                       "utopia_virt", "revelator_virt")
    for c in (1, 2, 4):
        members = t_systems.LADDERS[f"radix_{c}c"]
        assert members == tuple(f"{k}_{c}c" for k in (
            "radix", "victima", "pom", "victima_dramc"))
        assert t_systems.mix_cores(members) == c


@pytest.mark.parametrize("ladder", sorted(t_systems.LADDERS))
def test_ladder_base_config_and_dyn_are_the_reference_s(ladder):
    members = t_systems.LADDERS[ladder]
    got = t_systems.ladder_base_config(ladder)
    assert _fields(got) == _fields(
        j_systems.ladder_base_config(ladder, members))
    assert _fields(got) == _fields(t_systems.dyn_base_config(
        [t_systems.config(n) for n in members]))
    dyn, want = t_systems.ladder_dyn(members), j_systems.ladder_dyn(members)
    for f, a, b in zip(dyn._fields, dyn, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), (ladder, f)


# ------------------------------------------------ (c) the dyn step

_TINY_RS = dict(restseg4_sets=16, restseg2_sets=8, restseg_ways=4)
_TINY_REV = dict(rev_sets=16, rev_ways=4, rev_sig_bits=10)
_L3_POM = dict(l3tlb_ways=4, pom_sets=16, pom_ways=4)

# test_systems_registry's variant sets: (base overrides, variants) over
# GOLDEN_CFG, the _TINY geometry
VARIANT_SETS = {
    "l2tlb": ({}, [dict(l2tlb_sets=8, l2tlb_ways=4, l2tlb_lat=12),
                   dict(l2tlb_sets=16, l2tlb_ways=4, l2tlb_lat=17),
                   dict(l2tlb_sets=16, l2tlb_ways=8, l2tlb_lat=23)]),
    "l2_cache": ({}, [dict(l2_sets=16, l2_ways=4, victima=True),
                      dict(l2_sets=64, l2_ways=8, victima=False),
                      dict(l2_sets=32, l2_ways=8, victima=True)]),
    "virt": (dict(virt=True, l3_sets=16, pom_sets=16, pom_ways=4,
                  **_TINY_RS, **_TINY_REV),
             [dict(victima=False), dict(victima=True, l2_sets=16, l2_ways=4),
              dict(utopia=True), dict(pom=True), dict(revelator=True)]),
    "utopia": (_TINY_RS, [dict(utopia=True, restseg_ways=4), dict(),
                          dict(utopia=True, restseg_ways=8),
                          dict(utopia=True, victima=True, restseg_ways=8)]),
    "revelator": (_TINY_REV, [dict(revelator=True), dict(),
                              dict(revelator=True, victima=True)]),
    "l3_pom": (_L3_POM, [dict(), dict(l3tlb_sets=16), dict(pom=True),
                         dict(l3tlb_sets=16, l3tlb_lat=24)]),
    "all_gates": (dict(**_L3_POM, **_TINY_RS, **_TINY_REV),
                  [dict(), dict(utopia=True, victima=True),
                   dict(revelator=True), dict(pom=True),
                   dict(l3tlb_sets=16)]),
}


# a stage flag of the base config -> the counter its lanes must move
FIRED = {"victima": "n_victima_hit", "utopia": "n_restseg_mig",
         "revelator": "n_rev_enroll", "pom": "n_pom_hit",
         "l3tlb_sets": "n_l3tlb_hit", "virt": "n_ntlb_hit"}


def _variant_cfgs(name):
    over, variants = VARIANT_SETS[name]
    base = dataclasses.replace(GOLDEN_CFG, **over)
    return [dataclasses.replace(base, **v) for v in variants]


@functools.lru_cache(maxsize=None)
def _reference_dyn_runner(base):
    """The reference's dyn step under a plain ``lax.scan`` from
    ``make_state(base)``, the Dyn a traced argument (one compile a
    base): ``run(dyn, trace) -> (state, _finalize(state))``."""
    @jax.jit
    def run(dyn, tr):
        st = jax.lax.scan(j_mmu.make_step(base, dyn=dyn),
                          j_base.make_state(base), tr)[0]
        return st, j_mmu._finalize(st)

    return run


@pytest.mark.parametrize("variant_set", sorted(VARIANT_SETS))
def test_dyn_step_matches_the_reference_dyn_step(variant_set):
    """One lane a variant on the port (its Dyn stacked), against the
    reference's dyn step run once a variant: every Stats leaf, extra and
    state leaf exact."""
    cfgs = _variant_cfgs(variant_set)
    base = j_systems.dyn_base_config(cfgs)
    tr = golden_trace(N)
    tbase = port_cfg(base)
    dyn = t_base.stack_dyns([t_base.dyn_of(port_cfg(c)) for c in cfgs])
    S = len(cfgs)
    st = t_base.make_state(tbase, S)
    t_mmu.scan_accesses(
        t_mmu.make_step(tbase, dyn=dyn), st,
        {k: torch.from_numpy(np.ascontiguousarray(v))[:, None].repeat(1, S)
         for k, v in tr.items()}, tbase, None)
    got_leaves = t_base.state_to_numpy(st)
    stats, *rest = t_mmu._finalize(st, tbase)
    run = _reference_dyn_runner(base)
    jtr = {k: jnp.asarray(v) for k, v in tr.items()}
    for s, c in enumerate(cfgs):
        rst, (rstats, l2a, l2m, hd, ht, feats, pc4, shared) = run(
            j_base.dyn_of(c), jtr)
        what = (variant_set, s)
        assert_stats_equal(jax.tree.map(np.asarray, rstats),
                           t_base.Stats(*[x[s] for x in stats]), what)
        assert_extras_equal(
            j_mmu._extras_of(base, l2a, l2m, hd, ht, feats, pc4, shared),
            t_mmu._extras_of(tbase, *rest, index=lambda x, s=s: x[s]), what)
        want = [np.asarray(x) for x in jax.tree.leaves(rst)]
        assert len(want) == len(got_leaves)
        for i, (a, b) in enumerate(zip(want, got_leaves)):
            assert a.dtype == b.dtype and np.array_equal(a, b[s]), (what, i)
    assert int(stats.n_demand_ptw.min()) > 0
    for flag, field in FIRED.items():  # each gated stage of the base
        if getattr(base, flag):
            assert int(getattr(stats, field).sum()) > 0, (variant_set, field)


# ------------------------------------------- (d) simulate_systems S x W


def test_simulate_systems_lanes_equal_per_system_runs():
    """3 systems x 2 workloads as 6 lanes, system-major: each equals the
    port's own run of that system on that workload."""
    cfgs = [port_cfg(c) for c in _variant_cfgs("all_gates")[1:4]]
    base = t_systems.dyn_base_config(cfgs)
    trs = [golden_trace(400, seed) for seed in (1, 2)]
    traces = {k: np.stack([tr[k] for tr in trs], axis=1) for k in trs[0]}
    per, extras = t_mmu.simulate_systems(
        base, t_base.stack_dyns([t_base.dyn_of(c) for c in cfgs]), traces,
        device="cpu")
    assert [len(p) for p in per] == [2, 2, 2]
    for s, c in enumerate(cfgs):
        want, want_ex = t_mmu.simulate_batch(c, traces, device="cpu")
        for w in range(2):
            assert_stats_equal(want[w], per[s][w], (s, w))
            assert_extras_equal(want_ex[w], extras[s][w], (s, w))


# --------------------------------------------------- (e) auto_chunk


def test_auto_chunk_is_the_reference_s():
    for n in range(1, 21):
        assert t_runner.auto_chunk(n) == j_runner.auto_chunk(n), n
        for cap in (1, 3, 4, 8, 16):
            assert t_runner.auto_chunk(n, cap) == \
                j_runner.auto_chunk(n, cap), (n, cap)
    assert (t_runner.CHUNK, t_runner.CHUNK_MAX, t_runner.GEN_WORKERS) == \
        (j_runner.CHUNK, j_runner.CHUNK_MAX, j_runner.GEN_WORKERS)
    with pytest.raises(ValueError):
        t_runner.auto_chunk(0)


# -------------------------------------------------- (f) run_ladder

MEMBERS = ("radix", "victima")


def test_run_ladder_entries_equal_run_batch_s(tmp_path, monkeypatch):
    """Byte for byte, every (member, workload) cell of a two-member
    ladder fill equals run_batch's; three workloads in chunks of two, so
    the second chunk pads, and its padded lane is never stored."""
    n, seed, wls = 24, 5, ["bc", "rnd", "xs"]
    ladder_dir, batch_dir = tmp_path / "ladder", tmp_path / "batch"
    stored = []
    store = t_runner._store

    def spy(path, result):
        stored.append(os.path.basename(path))
        store(path, result)

    monkeypatch.setattr(t_runner, "_store", spy)
    monkeypatch.setattr(t_runner, "CACHE_DIR", str(ladder_dir))
    out = t_runner.run_ladder("radix", workloads=wls, n=n, seed=seed,
                              members=MEMBERS, chunk=2, device="cpu")
    assert sorted(stored) == sorted(
        t_runner._key(s, w, n, seed, None) + ".pkl"
        for s in MEMBERS for w in wls)
    monkeypatch.setattr(t_runner, "CACHE_DIR", str(batch_dir))
    for s in MEMBERS:
        t_runner.run_batch(s, workloads=wls, n=n, seed=seed, device="cpu")
    for s in MEMBERS:
        for w in wls:
            key = t_runner._key(s, w, n, seed, None) + ".pkl"
            assert (ladder_dir / key).read_bytes() == \
                (batch_dir / key).read_bytes(), (s, w)
            assert out[s][w][2].name == w


def test_run_ladder_reuses_cached_member_cells(tmp_path, monkeypatch):
    """A workload with some members cached re-simulates, but its cached
    cells come back as they are (bytes and mtime untouched), and only
    the missing cells are stored, in one dispatch at the width
    auto_chunk gives the full workload list."""
    monkeypatch.setattr(t_runner, "CACHE_DIR", str(tmp_path))
    wls, n, seed = ["bc", "bfs"], 64, 7
    sentinel = ({"marker": "seeded"}, {"extras": 1}, None)
    seeded = t_runner._path("radix", "bc", n, seed, None)
    t_runner._store(seeded, sentinel)
    stat0 = os.stat(seeded)
    bytes0 = open(seeded, "rb").read()
    calls = []

    def fake_make_systems_runner(cfg, stage_names=None, device=None):
        def fake_run(dyns, traces):
            S, W = dyns.l2tlb_lat.shape[0], traces["vpn"].shape[1]
            calls.append((S, W))
            return ([[t_base.zero_stats() for _ in range(W)]
                     for _ in range(S)],
                    [[{"stub": True} for _ in range(W)] for _ in range(S)])
        return fake_run

    monkeypatch.setattr(t_runner, "make_systems_runner",
                        fake_make_systems_runner)
    out = t_runner.run_ladder("radix", workloads=wls, n=n, seed=seed,
                              members=MEMBERS, device="cpu")
    assert out["radix"]["bc"] == sentinel
    assert open(seeded, "rb").read() == bytes0
    assert os.stat(seeded).st_mtime_ns == stat0.st_mtime_ns
    assert calls == [(len(MEMBERS), t_runner.auto_chunk(len(wls)))]
    for s, w in [("victima", "bc"), ("radix", "bfs"), ("victima", "bfs")]:
        assert out[s][w][1] == {"stub": True}, (s, w)
        assert os.path.exists(t_runner._path(s, w, n, seed, None)), (s, w)
    calls.clear()
    again = t_runner.run_ladder("radix", workloads=wls, n=n, seed=seed,
                                members=MEMBERS, device="cpu")
    assert calls == [] and again["radix"]["bc"] == sentinel


def test_run_ladder_fills_a_multicore_ladder(tmp_path, monkeypatch):
    """``radix_2c``'s fill: a workload is a mix spec, generated one lane a
    core, and each member's cell a per-core tuple that equals the
    member's own ``run``."""
    monkeypatch.setattr(t_runner, "CACHE_DIR", str(tmp_path))
    n, seed, mix = 12, 1, "bc+rnd"
    out = t_runner.run_ladder("radix_2c", workloads=[mix], n=n, seed=seed,
                              device="cpu")
    assert sorted(out) == sorted(t_systems.LADDERS["radix_2c"])
    for s, cells in out.items():
        stats, extras, spec = cells[mix]
        assert len(stats) == len(extras) == 2
        assert [x.name for x in spec] == ["bc", "rnd"]
        assert [int(x.n_access) for x in stats] == [n, n]
        want = t_runner.run(s, mix, n=n, seed=seed, cache=False,
                            device="cpu")
        for c in range(2):
            assert_stats_equal(want[0][c], stats[c], (s, c))
            assert_extras_equal(want[1][c], extras[c], (s, c))


def test_ladder_instantiations_are_listed_for_both_ladders():
    """The kernel's ladder compositions take each ladder's base
    composition, in the placement its geometry gives: the native and
    nested ones, and one for the three multicore ladders."""
    for ladder, (comp, placement) in {
            "radix": ("ladder_native", "device"),
            "np": ("ladder_np", "shared"),
            **{f"radix_{c}c": ("ladder_mc", "shared") for c in (1, 2, 4)},
    }.items():
        cfg = t_systems.ladder_base_config(ladder)
        names = t_mmu.default_stages(cfg)
        assert mmu_step.composition(cfg, names, dyn=True)[0] == comp
        assert mmu_step.placement(cfg).name == placement
        assert comp in mmu_step.LAUNCHES_BY_COMPOSITION
