"""The port's nested-paging stages (``repro_torch``: ``host_walk``,
``nested_translate``, the 2-D walker ``ptw2d``) against the JAX package,
on the CPU.

Each virtualized system -- ``np``, ``victima_virt``, ``pom_virt`` and
``isp`` (ideal shadow paging: the radix composition with ``virt=True``)
-- runs on its ``_TINY`` structures (``test_systems_registry``) over
``golden_trace(1000)``, as in ``test_torch_stages.py``; the reference
runs it in two halves of 500 accesses through one compiled scan, and
the port continues the reference's state after the first half too.
Every Stats leaf, extra and final state leaf must be exactly equal.
1000 accesses, not 2000: with a cold JAX compile cache this file took
about 190 s at 2000 on a 2-core CPU, and 120 s at 1000; every nested
counter still fires (``FIRED``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_trace import golden_trace
from repro.core import mmu as j_mmu
from repro.core import page_table as j_page_table
from repro.core.stages import base as j_base
from repro.core.stages import nested as j_nested
from repro.sim import systems as j_systems
from repro_torch.core import mmu as t_mmu
from repro_torch.core import page_table as t_page_table
from repro_torch.core.stages import base as t_base
from repro_torch.core.stages import nested as t_nested
from repro_torch.core.stages import victima as t_victima
from repro_torch.sim import systems as t_systems
from test_systems_registry import _tiny_config
from test_torch_mmu import assert_extras_equal, assert_stats_equal, port_cfg
from test_torch_stages import (_reference_runner, assert_runs_equal,
                               port_run)

N = 1000

# system -> the Stats counters its stages must have moved
FIRED = {"np": ("n_host_ptw", "n_ntlb_hit"),
         "victima_virt": ("n_host_ptw", "n_ntlb_hit", "n_nvictima_hit",
                          "n_victima_hit", "n_bg_ptw"),
         "pom_virt": ("n_host_ptw", "n_ntlb_hit", "n_pom_hit"),
         "isp": ()}


def _jax_trace(tr):
    return {k: jnp.asarray(v) for k, v in tr.items()}


@functools.lru_cache(maxsize=None)
def reference_halves(name: str, seed: int = 1234):
    """The reference run of `name` on ``golden_trace(N, seed)`` in two
    halves: (state after the first half, (leaves, Stats, extras) at the
    end)."""
    cfg = _tiny_config(name)
    tr = golden_trace(N, seed)
    run = _reference_runner(cfg)
    mid, _ = run(j_base.make_state(cfg),
                 _jax_trace({k: v[:N // 2] for k, v in tr.items()}))
    st, (stats, l2a, l2m, hd, ht, feats, pc4, shared) = run(
        mid, _jax_trace({k: v[N // 2:] for k, v in tr.items()}))
    extras = j_mmu._extras_of(cfg, l2a, l2m, hd, ht, feats, pc4, shared)
    return mid, ([np.asarray(x) for x in jax.tree.leaves(st)],
                 jax.tree.map(np.asarray, stats), extras)


@pytest.mark.parametrize("name", sorted(FIRED))
def test_system_matches_reference_on_tiny_structures(name, monkeypatch):
    cfg = _tiny_config(name)
    _, ref = reference_halves(name)
    got = port_run(cfg, golden_trace(N), monkeypatch)
    assert_runs_equal(ref, got, name)
    stats = got[1]
    for field in FIRED[name]:
        assert int(getattr(stats, field)) > 0, (name, field)
    if name == "isp":  # the radix walk: the nested TLB and pch untouched
        assert int(stats.n_host_ptw) == int(stats.n_ntlb_hit) == 0
        leaves = got[0]
        st = t_base.make_state(port_cfg(cfg))
        for i, x in enumerate(t_base.state_leaves(st)):
            if any(x is y for y in (*st.ntlb, *st.pch)):
                assert np.array_equal(leaves[i], x[0].numpy()), i


@pytest.mark.parametrize("name", sorted(FIRED))
def test_system_is_registered_as_in_the_reference(name):
    ref, got = j_systems.get(name), t_systems.get(name)
    assert (got.stages, got.overrides, got.tags) == \
        (ref.stages, ref.overrides, ref.tags)


def test_carried_state_continues_the_reference_np_run():
    """The port takes the reference's state after 500 accesses of `np`
    (``state_from_numpy``: the nested TLB and host-page counters at their
    virt sizes) and runs the second half to the reference's end."""
    cfg = _tiny_config("np")
    mid, (want, _, _) = reference_halves("np")
    tcfg = port_cfg(cfg)
    st = t_base.state_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(mid)], tcfg)
    assert tuple(st.ntlb.tags.shape) == (1, cfg.ntlb_sets, cfg.ntlb_ways)
    assert tuple(st.pch.freq.shape) == (1, cfg.n_pagesh)
    tr = golden_trace(N)
    names = t_systems.get("np").stages
    st = t_mmu.scan_accesses(
        t_mmu.make_step(tcfg, names), st,
        {k: torch.from_numpy(v[N // 2:].copy())[:, None]
         for k, v in tr.items()}, tcfg, names)
    got = t_base.state_to_numpy(st)
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.dtype == b.dtype and np.array_equal(a, b[0]), i


def test_simulate_batch_victima_virt_equals_reference_lanes():
    """Two lanes in lock-step equal the reference's run of each."""
    cfg = _tiny_config("victima_virt")
    seeds = (1234, 99)
    trs = [golden_trace(N, s) for s in seeds]
    traces = {k: np.stack([t[k] for t in trs], axis=1) for k in trs[0]}
    got, gex = t_mmu.simulate_batch(port_cfg(cfg), traces, device="cpu")
    for i, s in enumerate(seeds):
        _, (_, rstats, rex) = reference_halves("victima_virt", s)
        assert_stats_equal(rstats, got[i], i)
        assert_extras_equal(rex, gex[i], i)


def _mid_states(name):
    """The reference's mid-run state of `name` and the port's copy."""
    cfg = _tiny_config(name)
    mid, _ = reference_halves(name)
    tcfg = port_cfg(cfg)
    return cfg, tcfg, mid, t_base.state_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(mid)], tcfg)


def _assert_tree_equal(ref, got, what):
    want = [np.asarray(x) for x in jax.tree.leaves(ref)]
    have = [x[0].numpy() for x in t_base.state_leaves(got)]
    assert len(want) == len(have)
    for i, (a, b) in enumerate(zip(want, have)):
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, i)


# gPA pages: a data page of the trace, guest-PT lines' pages, the
# extremes of the page-id range
GPNS = [7, (j_page_table.LEAF4_BASE + 3) >> 6, (j_page_table.PD_BASE >> 6),
        0, (1 << 23) - 1]


@pytest.mark.parametrize("gpn", GPNS)
@pytest.mark.parametrize("pressure,enable", [(False, True), (True, True),
                                             (True, False)])
def test_host_walk_matches_reference(gpn, pressure, enable):
    cfg, tcfg, mid, st = _mid_states("np")
    h, cyc, nd, leaf = j_page_table.host_walk(
        mid.hier, jnp.int32(gpn), jnp.bool_(pressure), cfg.tlb_aware,
        cfg.lat, jnp.bool_(enable))
    one = torch.tensor([gpn], dtype=torch.int32)
    _, tcyc, tnd, tleaf = t_page_table.host_walk(
        st.hier, one, torch.tensor([pressure]), tcfg.tlb_aware, tcfg.lat,
        torch.tensor([enable]))
    assert [int(cyc), int(nd), int(leaf)] == \
        [int(tcyc[0]), int(tnd[0]), int(tleaf[0])]
    _assert_tree_equal(mid._replace(hier=h), st, "host_walk")


@pytest.mark.parametrize("name", ["np", "victima_virt"])
@pytest.mark.parametrize("gpn", GPNS)
@pytest.mark.parametrize("bypass", [False, True])
def test_nested_translate_matches_reference(name, gpn, bypass):
    cfg, tcfg, mid, st = _mid_states(name)
    ref = j_nested.nested_translate(cfg, mid, jnp.int32(gpn), jnp.bool_(True),
                                    jnp.bool_(bypass), jnp.bool_(True))
    got = t_nested.nested_translate(
        tcfg, st, torch.tensor([gpn], dtype=torch.int32),
        torch.tensor([True]), torch.tensor([bypass]), torch.tensor([True]))
    assert [int(x) for x in ref[1:]] == [int(x[0]) for x in got[1:]]
    _assert_tree_equal(ref[0], st, name)


def test_victima_virt_background_walk_is_the_radix_walk(monkeypatch):
    """victima_virt's demand walk is the 2-D walk (its walk_en and ndram
    feed Victima's fill), while the L2-TLB eviction's background walk
    stays the 1-D radix ``walk``, as in the reference."""
    calls = {"radix": 0, "bg": 0, "2d": 0}
    walk, walk2d = t_victima.walk, t_nested.guest_walk_2d

    def spy_walk(*args):
        calls["radix"] += 1
        calls["bg"] += int(args[8].sum())  # walk's `enable`
        return walk(*args)

    def spy_2d(*args):
        calls["2d"] += 1
        return walk2d(*args)

    monkeypatch.setattr(t_victima, "walk", spy_walk)
    monkeypatch.setattr(t_nested, "guest_walk_2d", spy_2d)
    n = 400
    stats, _ = t_mmu.simulate(port_cfg(_tiny_config("victima_virt")),
                              golden_trace(n), device="cpu")
    assert calls["2d"] == n == calls["radix"]
    assert calls["bg"] == int(stats.n_bg_ptw) > 0
    assert int(stats.n_host_ptw) > 0
