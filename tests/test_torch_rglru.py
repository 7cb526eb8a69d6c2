"""The port's hybrid family (recurrentgemma-2b) against the JAX package's.

Inputs are numpy draws from a seed; model parameters come from the JAX
``Model.init(PRNGKey(0))`` of the smoke config (5 layers: one
superblock of (rec, rec, attn) and a tail of 2 recurrent blocks, window
16) and are carried across by ``params_from_jax``.  The JAX side runs on
the CPU as its own tests run it; the port runs its plain path (the
attention kernels' plain versions; the RG-LRU recurrence is plain
PyTorch on every device).

Tolerances:
- float32: 1e-4 (atol and rtol), everywhere but the log-step scan's own
  checks.  Both sides compute the same products; the recurrence's
  float32 sums run in another order (the port's log-step scan against
  XLA's associative_scan tree), as do the attention's.  Measured on this
  smoke model: 2.5e-6 on the forward's logits, 4.5e-6 over 20 decode
  steps' logits and caches.
- The port's scan against its own step loop (``rglru_step`` token by
  token), float32: 1e-4, the bound the reference's tests hold its
  kernels' scans to against their step loops
  (``tests/test_kernels_ssd.py:63``).
- bf16, the forward and prefill logits only: 6.25e-2, the mamba2 tests'
  bf16 model bound (measured here: 4.2e-2 on logits of size ~1.5, where
  a bf16 ulp is 7.8e-3).  XLA on the CPU fuses the element-wise chains
  of the gates and the convolution and rounds to bf16 at other places
  than torch's one op at a time, and a decode step carries those
  roundings on through the state, so decode is compared in float32, as
  the moe tests do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import rglru as JR
from repro.models.model import build as jbuild
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM
from repro_torch.models import rglru as TR

ARCH = "recurrentgemma-2b"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_TOL = 1e-4
BF16_TOL = 6.25e-2
PAGE = 16            # divides the smoke window, the decode ring's length


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


def both(a: np.ndarray, dtype: str):
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype]))


def cfgs(dtype="float32"):
    jc = dataclasses.replace(jget_smoke(ARCH), dtype=dtype)
    tc = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=dtype)
    return jc, tc


@pytest.fixture(scope="module")
def hybrid():
    """dtype -> (JAX config, port config, JAX model, JAX params, port
    params)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc, tc = cfgs(dtype)
        m = jbuild(jc)
        jp = m.init(jax.random.PRNGKey(0))
        tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
        out[dtype] = (jc, tc, m, jp, tp)
    return out


def tokens(B, S, seed=7):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------- RG-LRU


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_apply_matches(hybrid, with_h0):
    """The gates, the clamp, the h0 term and the recurrence: y and the
    float32 h_last, over 40 positions (six rounds of the log-step
    scan)."""
    jc, tc, _, jp, tp = hybrid["float32"]
    rng = np.random.default_rng(1)
    jx, tx = both(rng.standard_normal((2, 40, 64), dtype=np.float32),
                  "float32")
    jh0 = th0 = None
    if with_h0:
        jh0, th0 = both(rng.standard_normal((2, 64), dtype=np.float32),
                        "float32")
    lp = jax.tree.map(lambda a: a[0], jp["super"])["rec1"]["lru"]
    jy, jh = JR.rglru_apply(lp, jx, jh0)
    ty, th = TR.rglru_apply(tp.super[0].rec1.lru, tx, th0)
    assert th.dtype == torch.float32 and ty.dtype == torch.float32
    assert_close(ty, jy, F32_TOL)
    assert_close(th, jh, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_step_matches(hybrid, dtype):
    """One decode step: the new state comes back rounded to x's dtype (in
    bf16, the cache's h), as the reference returns it.  bf16 within one
    bf16 ulp of the state's size (XLA fuses the float32 chain and
    rounds once, as torch does here)."""
    _, _, _, jp, tp = hybrid[dtype]
    rng = np.random.default_rng(2)
    jx, tx = both(rng.standard_normal((3, 64), dtype=np.float32), dtype)
    jh, th = both(rng.standard_normal((3, 64), dtype=np.float32), dtype)
    lp = jax.tree.map(lambda a: a[0], jp["tail"])["lru"]
    jy, jh2 = JR.rglru_step(lp, jx, jh)
    ty, th2 = TR.rglru_step(tp.tail[0].lru, tx, th)
    assert ty.dtype == th2.dtype == TDT[dtype]
    tol = F32_TOL if dtype == "float32" else 2.0 ** -7
    assert_close(ty, jy, tol)
    assert_close(th2, jh2, tol)


def test_scan_equals_its_step_loop():
    """The log-step scan against ``rglru_step`` token by token from h0
    (float32, a in (0.9, 0.999): the state remembers across all 100
    positions), and ``linear_scan`` against the sequential recurrence in
    float64."""
    _, tc = cfgs()
    params = TM.params_from_jax(TM.numpy_params(tc, 3), tc, "cpu")
    p = params.super[0].rec2.lru
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 100, 64), dtype=np.float32))
    h0 = torch.from_numpy(rng.standard_normal((2, 64), dtype=np.float32))
    y, h_last = TR.rglru_apply(p, x, h0)
    h = h0
    for t in range(x.shape[1]):
        yt, h = TR.rglru_step(p, x[:, t], h)
        assert_close(y[:, t], yt, F32_TOL)
    assert_close(h_last, h, F32_TOL)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, 77, 5)).astype(
        np.float32))
    u = torch.from_numpy(rng.standard_normal((3, 77, 5), dtype=np.float32))
    want, acc = torch.zeros_like(u, dtype=torch.float64), 0.0
    for t in range(u.shape[1]):
        acc = a[:, t].double() * acc + u[:, t].double()
        want[:, t] = acc
    assert_close(TR.linear_scan(a, u), want, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv4_and_its_decode_form_match(hybrid, dtype):
    """The prefill's 4-tap ``sum`` in x's dtype, and the decode step's
    ``sum(hist * w, axis=1)`` (each its own expression).  bf16 within one
    bf16 ulp of the outputs' size, float32 at F32_TOL."""
    _, _, _, jp, tp = hybrid[dtype]
    rng = np.random.default_rng(5)
    jx, tx = both(rng.standard_normal((2, 12, 64), dtype=np.float32), dtype)
    jb, tb = both(rng.standard_normal(64, dtype=np.float32) * 0.1, "float32")
    lp = jax.tree.map(lambda a: a[0], jp["super"])["rec1"]
    tl = tp.super[0].rec1
    tol = F32_TOL if dtype == "float32" else 2.0 ** -6
    got = TR.conv4(tx, tl.conv_w, tb)
    assert got.dtype == TDT[dtype]
    assert_close(got, JR._conv4(jx, lp["conv_w"], jb), tol)
    jh, th = both(rng.standard_normal((2, 4, 64), dtype=np.float32), dtype)
    want = jnp.sum(jh * lp["conv_w"][None], axis=1) + jb.astype(jh.dtype)
    got = torch.sum(th * tl.conv_w[None], dim=1) + tb.to(th.dtype)
    assert_close(got, want, tol)


# ---------------------------------------------------------------- blocks


def test_rec_block_matches(hybrid):
    """A recurrent block over 24 positions, alone, then continued from a
    state and a conv history (``h0``, ``conv0``, ``return_state``)."""
    jc, tc, _, jp, tp = hybrid["float32"]
    rng = np.random.default_rng(6)
    jx, tx = both(rng.standard_normal((2, 24, 64), dtype=np.float32),
                  "float32")
    lp = jax.tree.map(lambda a: a[1], jp["tail"])
    tl = tp.tail[1]
    assert_close(TR.rec_block_apply(tl, tc, tx),
                 JR.rec_block_apply(lp, jc, jx), F32_TOL)
    jh0, th0 = both(rng.standard_normal((2, 64), dtype=np.float32),
                    "float32")
    jc0, tc0 = both(rng.standard_normal((2, 3, 64), dtype=np.float32),
                    "float32")
    jy, (jhl, jcv) = JR.rec_block_apply(lp, jc, jx, h0=jh0, conv0=jc0,
                                        return_state=True)
    ty, (thl, tcv) = TR.rec_block_apply(tl, tc, tx, h0=th0, conv0=tc0,
                                        return_state=True)
    for got, want in ((ty, jy), (thl, jhl), (tcv, jcv)):
        assert_close(got, want, F32_TOL)


def test_attn_block_matches(hybrid):
    """The local-attention block at the smoke window (16) over 40
    positions, where the window binds, with the (k, v) it returns."""
    jc, tc, _, jp, tp = hybrid["float32"]
    rng = np.random.default_rng(8)
    jx, tx = both(rng.standard_normal((2, 40, 64), dtype=np.float32),
                  "float32")
    pos = np.broadcast_to(np.arange(40)[None], (2, 40))
    lp = jax.tree.map(lambda a: a[0], jp["super"])["attn"]
    jy, (jk, jv) = JR.attn_block_apply(lp, jc, jx, jnp.asarray(pos),
                                       return_kv=True)
    ty, (tk, tv) = TR.attn_block_apply(tp.super[0].attn, tc, tx,
                                       torch.from_numpy(pos.copy()),
                                       return_kv=True)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        assert_close(got, want, F32_TOL)


# ---------------------------------------------------------------- the slice


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_match(hybrid, dtype):
    """forward's logits at every position and prefill's (last position,
    no cache) over 40 tokens, past the window of 16."""
    jc, tc, jm, jp, tp = hybrid[dtype]
    tm = TM.build(tc, "cpu", page=PAGE)
    toks = tokens(2, 40)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    got = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 40, tc.padded_vocab) and got.dtype == torch.float32
    assert_close(got, jm.forward(jp, {"tokens": jnp.asarray(toks)},
                                 remat=False), tol)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert jcache is None and tcache is None
    assert tl.shape == (2, 1, tc.padded_vocab)
    assert_close(tl, jl, tol)


def test_decode_through_the_ring_wrap_matches(hybrid):
    """20 greedy decode steps from init_cache at position 0 over a ring of
    16 slots (the smoke window, pages of 16), so that steps 16-19 write
    over the oldest keys: logits and every cache leaf (h1 c1 h2 c2 k v th
    tc) after every step, float32."""
    jc, tc, jm, jp, tp = hybrid["float32"]
    tm = TM.build(tc, "cpu", page=PAGE)
    B, steps = 2, 20
    jcache = jm.init_cache(B, 32, jnp.float32)
    tcache = tm.init_cache(B, 32, torch.float32)
    assert set(tcache) == set(jcache)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    assert tcache["k"].shape[2] == tc.local_window
    tok = tokens(B, 1, seed=9)
    for i in range(steps):
        pos = np.full(B, i, np.int32)
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        assert_close(tl, jl, F32_TOL)
        for k in jcache:
            assert_close(tcache[k], jcache[k], F32_TOL)
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_decode_caches_keep_the_reference_dtypes(hybrid):
    """In bf16 the decode cache carries h in bf16 (``rglru_step`` rounds
    to x's dtype), while the prefill's recurrence ends in a float32
    h_last; a ring whose length the page does not divide raises."""
    jc, tc, jm, jp, tp = hybrid["bfloat16"]
    tm = TM.build(tc, "cpu", page=PAGE)
    cache = tm.init_cache(2, 64)
    lg, cache = tm.decode_step(tp, cache, torch.zeros(2, 1, dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32))
    assert all(v.dtype == torch.bfloat16 for v in cache.values())
    assert bool(torch.isfinite(lg).all()) and bool(cache["h1"].abs().sum() > 0)
    x = torch.zeros(2, 5, 64, dtype=torch.bfloat16)
    _, (h_last, conv) = TR.rec_block_apply(tp.tail[0], tc, x,
                                           return_state=True)
    assert h_last.dtype == torch.float32 and conv.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="multiple of the page"):
        TM.build(tc, "cpu", page=PAGE).decode_step(
            tp, tm.init_cache(2, 12), torch.zeros(2, 1, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="no cache"):
        tm.prefill(tp, {"tokens": torch.zeros(1, 8, dtype=torch.int32)},
                   tm.init_cache(1, 16))


def test_params_round_trip_and_init(hybrid):
    """params_to_numpy gives back the JAX tree bit for bit; param_shapes
    is its shape table; the port's own init and numpy_params draw
    a = exp(-8 softplus(a_param)) in (0.9, 0.999), as the reference's
    init does, with zero gate biases."""
    _, tc, _, jp, tp = hybrid["bfloat16"]
    tree = jax.tree.map(np.asarray, jp)
    back = TM.params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert TM.param_shapes(tc) == {
        p: a.shape for p, a in TM._flatten(tree).items()}
    m = TM.build(tc, "cpu")
    own = TM.params_to_numpy(m.init(torch.Generator().manual_seed(0)))
    drawn = TM.numpy_params(tc, 0)
    for t in (own, drawn, tree):
        for lru in (t["super"]["rec1"]["lru"], t["tail"]["lru"]):
            a = np.exp(-8.0 * np.logaddexp(lru["a_param"], 0.0))
            assert a.min() > 0.9 - 1e-6 and a.max() < 0.999 + 1e-6
            assert not lru["ba"].any() and not lru["bx"].any()
            assert lru["a_param"].dtype == np.float32
    assert {p: a.shape for p, a in TM._flatten(own).items()} == \
        TM.param_shapes(tc)
    std = drawn["super"]["rec1"]["lru"]["wa"].std()
    assert abs(std - 1 / np.sqrt(64 // 16)) < 0.1    # fan_in W / 16
