"""The port's L3-TLB and POM-TLB stages (``repro_torch``) against the JAX
package, on the CPU.

Each system runs on its ``_TINY`` structures (``test_systems_registry``:
L3 TLB and POM shadow 16 x 4) over ``golden_trace(2000)``.  The
reference side is ``repro.core.mmu.simulate``'s own body -- ``make_step``
scanned by ``lax.scan`` from ``make_state``, then ``_finalize`` and
``_extras_of`` -- so that its final state is compared too; the port side
is ``repro_torch.core.mmu.simulate`` on ``device="cpu"``, whose state is
caught at ``scan_accesses``.  Every Stats leaf, extra and final state
leaf must be exactly equal, and each stage must have fired.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_trace import golden_trace
from repro.core import mmu as j_mmu
from repro.core.stages import base as j_base
from repro.sim import systems as j_systems
from repro_torch.core import mmu as t_mmu
from repro_torch.core.stages import (base as t_base, default_stages,
                                     fill_order)
from repro_torch.sim import systems as t_systems
from test_systems_registry import _tiny_config
from test_torch_mmu import assert_extras_equal, assert_stats_equal, port_cfg

N = 2000


@functools.lru_cache(maxsize=None)
def _reference_runner(cfg):
    """The reference's scan from a given state, jitted once a config:
    ``run(state, trace) -> (state, _finalize(state))``."""
    step = j_mmu.make_step(cfg)

    @jax.jit
    def run(st, tr):
        st = jax.lax.scan(step, st, tr)[0]
        return st, j_mmu._finalize(st)

    return run


def reference_run(cfg, trace: dict, st0=None):
    """(final state leaves, Stats, extras) of the reference, as numpy;
    from ``make_state`` or from the reference state ``st0``."""
    st, (stats, l2a, l2m, hd, ht, feats, pc4, shared) = \
        _reference_runner(cfg)(
            j_base.make_state(cfg) if st0 is None else st0,
            {k: jnp.asarray(v) for k, v in trace.items()})
    extras = j_mmu._extras_of(cfg, l2a, l2m, hd, ht, feats, pc4, shared)
    return ([np.asarray(x) for x in jax.tree.leaves(st)],
            jax.tree.map(np.asarray, stats), extras)


def port_run(cfg, trace: dict, monkeypatch):
    """(final state leaves, Stats, extras) of the port's ``simulate``."""
    caught = []

    def scan(*args):
        caught.append(t_mmu.mmu_step.blocked_scan(*args))
        return caught[-1]

    monkeypatch.setattr(t_mmu, "scan_accesses", scan)
    stats, extras = t_mmu.simulate(port_cfg(cfg), trace, device="cpu")
    (st,) = caught
    return [x[0] for x in t_base.state_to_numpy(st)], stats, extras


def assert_runs_equal(ref, got, what):
    (rs, rstats, rex), (gs, gstats, gex) = ref, got
    assert_stats_equal(rstats, gstats, what)
    assert_extras_equal(rex, gex, what)
    assert len(rs) == len(gs)
    for i, (a, b) in enumerate(zip(rs, gs)):
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, i)


# system -> the Stats counters its stages must have moved
FIRED = {"pom": ("n_pom_hit",), "l3tlb_64k_15": ("n_l3tlb_hit",),
         "l3tlb_64k_24": ("n_l3tlb_hit",), "l3tlb_64k_39": ("n_l3tlb_hit",)}


@pytest.mark.parametrize("name", sorted(FIRED))
def test_system_matches_reference_on_tiny_structures(name, monkeypatch):
    cfg = _tiny_config(name)
    tr = golden_trace(N)
    ref = reference_run(cfg, tr)
    got = port_run(cfg, tr, monkeypatch)
    assert_runs_equal(ref, got, name)
    stats = got[1]
    for field in FIRED[name]:
        assert int(getattr(stats, field)) > 0, (name, field)
    assert int(stats.n_host_ptw) == int(stats.n_ntlb_hit) == 0


@pytest.mark.parametrize("name", sorted(FIRED))
def test_system_is_registered_as_in_the_reference(name):
    ref, got = j_systems.get(name), t_systems.get(name)
    assert (got.stages, got.overrides, got.tags) == \
        (ref.stages, ref.overrides, ref.tags)
    assert default_stages(got.config()) == got.stages


@pytest.mark.parametrize("names,want", [
    (("l1_tlb", "l2_tlb", "l3_tlb", "ptw"),
     ("ptw", "l2_tlb", "l3_tlb", "l1_tlb")),
    (("l1_tlb", "l2_tlb", "pom", "ptw"), ("ptw", "l2_tlb", "pom", "l1_tlb")),
    (("l1_tlb", "l2_tlb", "pom", "ptw2d"),
     ("ptw2d", "l2_tlb", "pom", "l1_tlb")),
    (("l1_tlb", "l2_tlb", "victima", "ptw2d"),
     ("l2_tlb", "victima", "l1_tlb")),
])
def test_fill_order_matches_reference(names, want):
    from repro.core import stages as j_stages
    assert fill_order(names) == j_stages.fill_order(names) == want


def test_config_takes_the_new_stages():
    cfg = t_base.SimConfig(l3tlb_sets=16, pom=True, virt=True)
    assert default_stages(cfg) == ("l1_tlb", "l2_tlb", "l3_tlb", "pom",
                                   "ptw2d")
    st = t_base.make_state(cfg, lanes=2)
    assert tuple(st.l3tlb.tags.shape) == (2, 16, 16)
    assert tuple(st.pom.tags.shape) == (2, 4096, 16)
    assert tuple(st.ntlb.tags.shape) == (2, 16, 4)
    assert tuple(st.pch.freq.shape) == (2, 1 << 14)


@pytest.mark.parametrize("x", [0, 1, -1, np.iinfo(np.int32).min,
                               np.iinfo(np.int32).max, 123456789])
@pytest.mark.parametrize("n", [1 << 8, 1 << 14])
def test_hash_h_wraps_as_the_reference(x, n):
    want = np.asarray(j_base.hash_h(jnp.asarray([x], jnp.int32), n))
    got = t_base.hash_h(torch.tensor([x], dtype=torch.int32), n)
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()


@functools.lru_cache(maxsize=None)
def _pom_line_trace():
    """Keys that share POM lines (4 entries a 64-byte line): 4K pages 0-23
    three times over (more than the tiny L2 TLB holds, fewer than the POM
    shadow), then the 2M pages 0-23 twice."""
    vpn = np.concatenate([np.tile(np.arange(24), 3),
                          np.tile(np.arange(24) << 9, 2)]).astype(np.int32)
    is2m = np.arange(len(vpn)) >= 72
    return {"vpn": vpn, "is2m": is2m,
            "line": (vpn * 64).astype(np.int32),
            "ipa": np.full(len(vpn), 3.0, np.float32)}


def test_pom_fills_walked_then_evicted_entry(monkeypatch):
    """A trace that evicts from the tiny L2 TLB into a small POM shadow:
    the walked entry and the L2 TLB's victim both land, in the
    reference's order (every leaf equal)."""
    cfg = _tiny_config("pom")
    tr = _pom_line_trace()
    got = port_run(cfg, tr, monkeypatch)
    assert_runs_equal(reference_run(cfg, tr), got, "pom lines")
    assert int(got[1].n_pom_hit) > 0
