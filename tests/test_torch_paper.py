"""The port's paper tables (``repro_torch.sim.paper``) and Table-2 study
(``repro_torch.core.ptwcp_nn``) against the reference, on the CPU.

- Every ported figure function, fed the same seeded synthetic Stats and
  extras as ``benchmarks/paper.py``'s (loaded by path; its ``WLS`` and
  ``_sys`` patched in the test, no file edited), gives the same
  ``(name, derived)`` rows.  Table 2's MLPs are replaced on both sides by
  the same stub there: their training is held against JAX's below.
- ``fig4_ptw_latency`` and ``fig11_reuse`` end to end at n = 500 on two
  workloads, against the reference's ``run_batch`` (no ladder).
- ``ptwcp_nn``: ``build_dataset``, ``fit_box`` and the comparator rows
  exactly; ``train_mlp`` from JAX's initial draw, its final weights
  within 1e-4 of JAX's and its predictions on at most 0.5% of the rows
  apart.
"""
import functools
import importlib.util
import os
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ptwcp as j_ptwcp
from repro.core import ptwcp_nn as j_nn
from repro.core.stages import base as j_base
from repro.sim import runner as j_runner
from repro.sim import trace_gen as j_trace_gen
from repro_torch.core import ptwcp as t_ptwcp
from repro_torch.core import ptwcp_nn as t_nn
from repro_torch.core.stages import base as t_base
from repro_torch.sim import paper as t_paper
from repro_torch.sim import runner as t_runner
from repro_torch.sim import trace_gen as t_trace_gen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WLS = ["bc", "rnd", "xs"]
N_FEAT = 512


@functools.lru_cache(maxsize=None)
def reference_paper():
    spec = importlib.util.spec_from_file_location(
        "paper_reference", os.path.join(ROOT, "benchmarks", "paper.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def synthetic(system: str, workload: str) -> dict:
    """Seeded Stats fields and extras of one (system, workload)."""
    rng = np.random.default_rng(zlib.crc32(f"{system}/{workload}".encode()))
    n = 20_000
    miss = int(rng.integers(500, 8000))
    walks = int(rng.integers(100, miss))
    st = {}
    for f in j_base.Stats._fields:
        if f.startswith("hist_"):
            st[f] = rng.integers(0, 400, 64).astype(np.int32)
        elif f.startswith("sum_"):
            st[f] = np.float32(rng.uniform(1e3, 4e6))
        else:
            st[f] = np.int32(rng.integers(0, walks))
    st.update(n_access=np.int32(n), n_l2tlb_miss=np.int32(miss),
              n_demand_ptw=np.int32(walks),
              sum_trans_cyc=np.float32(rng.uniform(2e4, 2e6)),
              sum_data_cyc=np.float32(rng.uniform(8e4, 4e6)))
    ex = {"l2_access": int(rng.integers(1000, 20000)),
          "l2_miss": int(rng.integers(0, 1000)),
          "hist_reuse_data": rng.integers(0, 900, 22).astype(np.int32),
          "hist_reuse_tlb": rng.integers(0, 900, 22).astype(np.int32)}
    if system == "radix_collect":
        acc = rng.integers(0, 6, N_FEAT)
        acc[rng.random(N_FEAT) < 0.2] = 0
        l1 = np.minimum(acc, rng.integers(0, 6, N_FEAT))
        l2 = np.minimum(l1, rng.integers(0, 6, N_FEAT))
        wc = np.where(l2 > 0, rng.uniform(0, 900, N_FEAT), 0)
        ex["feats"] = dict(
            n_access=acc.astype(np.uint16), n_l1_miss=l1.astype(np.uint16),
            n_l2_miss=l2.astype(np.uint16),
            n_walk=np.minimum(l2, rng.integers(0, 6, N_FEAT)).astype(
                np.uint16),
            walk_cyc=wc.astype(np.float32),
            is2m=(rng.random(N_FEAT) < 0.3).astype(np.uint8))
        ex["pc4"] = dict(freq=rng.integers(0, 8, 4 * N_FEAT).astype(np.uint8),
                         cost=rng.integers(0, 16, 4 * N_FEAT).astype(
                             np.uint8))
    return {"stats": st, "extras": ex}


def results(pkg: str, system: str) -> dict:
    """``run_batch``'s result for `system` over WLS, as package `pkg`
    ("ref" or "port") would return it."""
    stats_t, feats_t, pc_t, tg = (
        (j_base.Stats, j_base.Feats, j_ptwcp.PageCounters, j_trace_gen)
        if pkg == "ref" else
        (t_base.Stats, t_base.Feats, t_ptwcp.PageCounters, t_trace_gen))
    out = {}
    for w in WLS:
        s = synthetic(system, w)
        ex = dict(s["extras"])
        if "feats" in ex:
            ex["feats"] = feats_t(**ex["feats"])
            ex["pc4"] = pc_t(**ex["pc4"])
        out[w] = (stats_t(**s["stats"]), ex, tg.WORKLOADS[w])
    return out


def _stub_mlp(nn):
    """The same deterministic stand-in for ``train_mlp`` in either
    package: predicts from the sum of the chosen features."""
    def train_mlp(X, y, feat_idx, hidden, layers=2, steps=300, seed=0,
                  name="NN", **_):
        x = X[:, feat_idx].sum(1)
        pred = (x > np.median(x)).astype(np.float32)
        dims = [len(feat_idx)] + [hidden] * layers + [1]
        nbytes = 4 * sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        return nn.NNResult(name, nbytes, *nn._metrics(pred, y))
    return train_mlp


# multicore_scaling's rows are held against the reference in
# tests/test_torch_multicore.py (per-core results, its own fetch)
@pytest.mark.parametrize("fig", [f.__name__ for f in t_paper.ALL
                                 if f is not t_paper.multicore_scaling])
def test_figure_rows_equal_the_reference(fig, monkeypatch):
    paper = reference_paper()
    monkeypatch.setattr(paper, "WLS", WLS)
    monkeypatch.setattr(paper, "_sys",
                        lambda name: (results("ref", name), 0.0))
    monkeypatch.setattr(j_nn, "train_mlp", _stub_mlp(j_nn))
    monkeypatch.setattr(t_nn, "train_mlp", _stub_mlp(t_nn))
    want = [(r[0], r[2]) for r in getattr(paper, fig)()]
    fetched = []

    def fetch(name):
        fetched.append(name)
        return results("port", name)

    rows = getattr(t_paper, fig)(workloads=WLS, n=20_000, device="cpu",
                                 fetch=fetch)
    assert [(r[0], r[2]) for r in rows] == want
    assert all(isinstance(r[1], float) and r[1] >= 0 for r in rows)
    assert fetched


def test_every_reference_figure_is_ported_or_raises():
    """Every figure of the reference's ALL is ported, in its order."""
    names = [f.__name__ for f in reference_paper().ALL]
    assert [f.__name__ for f in t_paper.ALL] == names
    assert "multicore_scaling" in names


def test_figures_refuse_an_unknown_workload():
    with pytest.raises(ValueError, match="unknown workload"):
        t_paper.fig4_ptw_latency(workloads=["nope"], device="cpu",
                                 fetch=lambda name: {})


@functools.lru_cache(maxsize=None)
def _end_to_end_radix(n=500, wls=("rnd", "bc")):
    """(reference run_batch, port run_batch) of radix at Table 3."""
    old = j_runner.CACHE_DIR
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        j_runner.CACHE_DIR = tmp
        try:
            ref = j_runner.run_batch("radix", workloads=list(wls), n=n)
        finally:
            j_runner.CACHE_DIR = old
    port = t_runner.run_batch("radix", workloads=list(wls), n=n,
                              cache=False, device="cpu")
    return ref, port


@pytest.mark.parametrize("fig", ["fig4_ptw_latency", "fig11_reuse"])
def test_figure_end_to_end_against_reference_run_batch(fig, monkeypatch):
    ref, port = _end_to_end_radix()
    paper = reference_paper()
    monkeypatch.setattr(paper, "WLS", ["rnd", "bc"])
    monkeypatch.setattr(paper, "_sys", lambda name: (ref, 0.0))
    want = [(r[0], r[2]) for r in getattr(paper, fig)()]
    rows = getattr(t_paper, fig)(workloads=["rnd", "bc"], n=500,
                                 device="cpu", fetch=lambda name: port)
    assert [(r[0], r[2]) for r in rows] == want
    for w in ("rnd", "bc"):
        for f in t_base.Stats._fields:
            assert np.array_equal(np.asarray(getattr(ref[w][0], f)),
                                  np.asarray(getattr(port[w][0], f))), f


# ------------------------------------------------------------ ptwcp_nn


@functools.lru_cache(maxsize=None)
def dataset():
    """Collect-mode extras of the three synthetic workloads, as the
    reference and the port take them, and the reference's (X, y)."""
    ref = [results("ref", "radix_collect")[w][1] for w in WLS]
    port = [results("port", "radix_collect")[w][1] for w in WLS]
    return ref, port, j_nn.build_dataset(ref)


def test_build_dataset_equals_the_reference():
    _, port, (X, y) = dataset()
    tX, ty = t_nn.build_dataset(port)
    assert tX.dtype == X.dtype and np.array_equal(tX, X)
    assert ty.dtype == y.dtype and np.array_equal(ty, y)
    assert 0 < y.sum() < len(y)


def test_fit_box_and_comparators_equal_the_reference():
    _, _, (X, y) = dataset()
    box = j_nn.fit_box(X, y)
    assert t_nn.fit_box(X, y) == box
    for b, name in ((None, "Comparator(paper-box)"),
                    (box, f"Comparator(refit {box})")):
        want = j_nn.comparator_result(X, y, b, name=name)
        got = t_nn.comparator_result(X, y, b, name=name)
        assert got.__dict__ == want.__dict__


def jax_train(X, y, feat_idx, hidden, layers=2, steps=300, seed=0):
    """``repro.core.ptwcp_nn.train_mlp``'s body, returning its initial
    and final layers and its predictions."""
    Xs = jnp.asarray(X[:, feat_idx])
    mu, sd = Xs.mean(0), Xs.std(0) + 1e-6
    Xs = (Xs - mu) / sd
    yv = jnp.asarray(y)
    key = jax.random.PRNGKey(seed)
    dims = [len(feat_idx)] + [hidden] * layers + [1]
    ws = []
    for i in range(len(dims) - 1):
        key, k = jax.random.split(key)
        ws.append((jax.random.normal(k, (dims[i], dims[i + 1]))
                   / np.sqrt(dims[i]), jnp.zeros(dims[i + 1])))
    init = [(np.asarray(w), np.asarray(b)) for w, b in ws]

    def fwd(ws, x):
        for w, b in ws[:-1]:
            x = jax.nn.relu(x @ w + b)
        w, b = ws[-1]
        return (x @ w + b)[:, 0]

    def loss(ws):
        logit = fwd(ws, Xs)
        return jnp.mean(jnp.maximum(logit, 0) - logit * yv
                        + jnp.log1p(jnp.exp(-jnp.abs(logit))))

    g_fn = jax.jit(jax.grad(loss))
    for _ in range(steps):
        g = g_fn(ws)
        ws = jax.tree.map(lambda p, gg: p - 0.05 * gg, ws, g)
    pred = np.asarray((jax.nn.sigmoid(fwd(ws, Xs)) > 0.5).astype(
        np.float32))
    return init, [(np.asarray(w), np.asarray(b)) for w, b in ws], pred


@pytest.mark.parametrize("name,idx,hidden", t_nn.MLPS)
def test_train_mlp_follows_jax_from_its_initial_draw(name, idx, hidden):
    _, _, (X, y) = dataset()
    init, want, want_pred = jax_train(X, y, idx, hidden)
    # the mirror above is the reference's trainer
    ref = j_nn.train_mlp(X, y, idx, hidden=hidden, name=name)
    assert ref.__dict__ == j_nn.NNResult(
        name, ref.params_bytes, *j_nn._metrics(want_pred, y)).__dict__
    got, pred = t_nn.train(X, y, idx, hidden, device="cpu", init=init)
    for (w, b), (gw, gb) in zip(want, got):
        assert gw.shape == w.shape and gb.shape == b.shape
        np.testing.assert_allclose(gw, w, rtol=0, atol=1e-4)
        np.testing.assert_allclose(gb, b, rtol=0, atol=1e-4)
    assert np.mean(pred != want_pred) <= 0.005
    res = t_nn.train_mlp(X, y, idx, hidden, name=name, device="cpu",
                         init=init)
    assert (res.name, res.params_bytes) == (name, ref.params_bytes)
    assert abs(res.f1 - ref.f1) <= 0.005


def test_run_study_order_and_generator_draw():
    _, port, (X, y) = dataset()
    rows = t_nn.run_study(port, device="cpu")
    assert [r.name for r in rows[:4]] == ["NN-6", "NN-4", "NN-2",
                                         "Comparator(paper-box)"]
    assert rows[4].name.startswith("Comparator(refit ")
    # the generator's draw is a function of the seed alone
    a = t_nn.init_weights([4, 8, 8, 1], seed=0)
    b = t_nn.init_weights([4, 8, 8, 1], seed=0)
    c = t_nn.init_weights([4, 8, 8, 1], seed=1)
    assert all(torch.equal(x[0], y_[0]) for x, y_ in zip(a, b))
    assert not torch.equal(a[0][0], c[0][0])


def test_train_mlp_refuses_a_mis_shaped_init():
    _, _, (X, y) = dataset()
    with pytest.raises(ValueError, match="init layer"):
        t_nn.train(X, y, [1, 2], 4, device="cpu",
                   init=[(np.zeros((3, 4)), np.zeros(4))] * 3)


def test_paper_modules_import_neither_jax_nor_repro():
    code = (
        "import sys, runpy\n"
        "import repro_torch.sim.paper, repro_torch.core.ptwcp_nn\n"
        "runpy.run_path('examples/victima_paper_repro_torch.py',"
        " run_name='not_main')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
