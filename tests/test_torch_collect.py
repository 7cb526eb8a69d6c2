"""The port's Table-2 feature stream (``collect_feats``, the
``radix_collect`` system, the ``feats`` and ``pc4`` extras) against the
JAX package, on the CPU.

``radix_collect`` runs on its ``_TINY`` structures over
``golden_trace(N)``, whose 4096 pages hash into a feature table of
``n_feat`` entries (small, so that pages share entries); the reference
side is ``repro.core.mmu``'s own scan, as in tests/test_torch_stages.py.
Every Stats leaf, extra and final state leaf must be exactly equal, the
features with the reference's dtypes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_trace import golden_trace
from repro.core.stages import base as j_base
from repro.sim import systems as j_systems
from repro_torch.core import mmu as t_mmu
from repro_torch.core.stages import base as t_base
from repro_torch.core.stages import default_stages
from repro_torch.sim import systems as t_systems
from test_systems_registry import _tiny_config
from test_torch_mmu import port_cfg
from test_torch_stages import (_reference_runner, assert_runs_equal,
                               port_run, reference_run)

N = 1500


def assert_feats_equal(ref: dict, got: dict, what):
    for key in ("feats", "pc4"):
        assert type(got[key]).__name__ == type(ref[key]).__name__
        assert got[key]._fields == ref[key]._fields
        for f, a, b in zip(ref[key]._fields, ref[key], got[key]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), \
                (what, key, f)


def collect_cfg(n_feat: int):
    return dataclasses.replace(_tiny_config("radix_collect"), n_feat=n_feat)


@pytest.mark.parametrize("n_feat", [1 << 6, 1 << 10])
def test_radix_collect_matches_reference(n_feat, monkeypatch):
    cfg = collect_cfg(n_feat)
    tr = golden_trace(N)
    ref = reference_run(cfg, tr)
    got = port_run(cfg, tr, monkeypatch)
    assert_runs_equal(ref, got, f"radix_collect n_feat={n_feat}")
    assert_feats_equal(ref[2], got[2], n_feat)
    ft = got[2]["feats"]
    assert ft.n_access.dtype == np.uint16 and ft.is2m.dtype == np.uint8
    assert int(ft.n_access.sum()) == N
    for f in ("n_l1_miss", "n_l2_miss", "n_walk"):
        assert int(getattr(ft, f).sum()) > 0, f
    assert float(ft.walk_cyc.sum()) == pytest.approx(
        float(got[1].sum_walk_cyc), rel=1e-6)
    # a feature entry past one collision: two pages hash onto it
    vpn_sz = np.where(tr["is2m"], tr["vpn"] >> 9, tr["vpn"]).astype(np.int32)
    fi = np.asarray(j_base.hash_h(jnp.asarray(vpn_sz), n_feat))
    shared = [i for i in np.unique(fi) if len(np.unique(vpn_sz[fi == i])) > 1]
    assert shared and int(ft.n_access[shared[0]]) > 1


def test_radix_collect_is_the_radix_run_plus_the_features(monkeypatch):
    """The feature stream changes no Stats leaf: radix_collect's Stats
    are radix's on the same trace."""
    cfg = collect_cfg(1 << 10)
    tr = golden_trace(N)
    got = port_run(cfg, tr, monkeypatch)
    base, extras = t_mmu.simulate(
        port_cfg(dataclasses.replace(cfg, collect=False)), tr, device="cpu")
    for f, a, b in zip(base._fields, base, got[1]):
        assert np.array_equal(a, b), f
    assert "feats" not in extras and "pc4" not in extras


def test_feature_counters_wrap_at_2_16():
    """From a reference state whose counters stand just below 2^16, both
    packages wrap each counter the way uint16 does."""
    cfg = collect_cfg(1 << 6)
    tr = {k: v[:400] for k, v in golden_trace(N).items()}
    st0 = j_base.make_state(cfg)
    high = jnp.full((cfg.n_feat,), 65530, jnp.uint16)
    st0 = st0._replace(feats=st0.feats._replace(
        n_access=high, n_l1_miss=high, n_l2_miss=high, n_walk=high))
    st, _ = _reference_runner(cfg)(
        st0, {k: jnp.asarray(v) for k, v in tr.items()})
    want = [np.asarray(x) for x in jax.tree.leaves(st)]
    assert int(np.asarray(st.feats.n_access).min()) < 100  # wrapped

    tcfg = port_cfg(cfg)
    tst = t_base.state_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(st0)], tcfg)
    assert tst.feats.n_access.dtype == torch.uint16
    names = t_systems.get("radix_collect").stages
    tst = t_mmu.scan_accesses(
        t_mmu.make_step(tcfg, names), tst,
        {k: torch.from_numpy(np.ascontiguousarray(v))[:, None]
         for k, v in tr.items()}, tcfg, names)
    got = [x[0] for x in t_base.state_to_numpy(tst)]
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.dtype == b.dtype and np.array_equal(a, b), i


def test_simulate_batch_collect_extras_per_lane():
    """Two lanes in lock-step: each lane's feats and pc4 extras equal the
    reference's run of that lane."""
    cfg = collect_cfg(1 << 8)
    trs = [golden_trace(600, seed) for seed in (1234, 99)]
    stacked = {k: np.stack([t[k] for t in trs], axis=1) for k in trs[0]}
    _, extras = t_mmu.simulate_batch(port_cfg(cfg), stacked, device="cpu")
    for tr, got in zip(trs, extras):
        assert_feats_equal(reference_run(cfg, tr)[2], got, "lane")


def test_radix_collect_is_registered_as_in_the_reference():
    ref, got = j_systems.get("radix_collect"), t_systems.get(
        "radix_collect")
    assert (got.stages, got.overrides, got.tags, got.desc) == \
        (ref.stages, ref.overrides, ref.tags, ref.desc)
    assert default_stages(got.config()) == got.stages
    cfg = got.config()
    st = t_base.make_state(cfg, lanes=2)
    assert tuple(st.feats.n_access.shape) == (2, 1 << 20)
    ref_leaves = jax.tree.leaves(j_base.make_state(j_systems.config(
        "radix_collect")).feats)
    assert [(x.shape, np.dtype(x.dtype)) for x in ref_leaves] == \
        [(tuple(x.shape[1:]), x.numpy().dtype) for x in st.feats]

