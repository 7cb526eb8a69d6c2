"""The port's encoder-decoder (seamless-m4t-medium) against the JAX
package's, at the smoke config (2 + 2 layers, d_model 64, 4 heads MHA).

Parameters come from the JAX ``Model.init(PRNGKey(0))`` and are carried
across by ``params_from_jax``; tokens and source frames are numpy draws
from a seed, the source longer than the target (Sk != S at the cross
attention).  The JAX side runs on the CPU as its own tests run it; the
port runs its plain path.

Decode starts from ``init_cache`` at position 0, as the reference's
encdec decode does (its prefill returns no cache).  Nothing in either
package fills the cross cache: the test decodes once over zeros, and
once over a cross cache each side fills from its own ``encode`` output
and the decoder's ``cross.wk``/``wv``, longer than the source, so that
the slots past it stay zero and are attended all the same (the
reference's zero bias over every slot).

Tolerances: float32 1e-4 on the encoder's output, logits and caches, as
the dense tests (tests/test_torch_model.py).  bfloat16 8e-2 on the
encoder's output and logits, 6.25e-2 on caches.  bf16 rounds at other
places in the two (the reference rounds attention weights to bf16 before
the PV product, the port's plain versions keep them in float32), and
here four layers of it (two encoder, two decoder with cross-attention)
reach logits of size ~4.5, where a bf16 ulp is 3.1e-2: measured, the
reference's own bf16 logits lie 6.4e-2 from its float32 ones and the
port's 5.5e-2, and the two bf16 results 6.2e-2 from each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models.model import build as jbuild
from repro_torch import configs as tconfigs
from repro_torch.models import encdec as TED
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

ARCH = "seamless-m4t-medium"
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-2, 6.25e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, ST, SS, CACHE, PAGE = 2, 24, 40, 48, 16


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def models():
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc = dataclasses.replace(jget_smoke(ARCH), dtype=dtype)
        tc = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                                 dtype=dtype)
        jm = jbuild(jc)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
        out[dtype] = (jc, tc, jm, jp, TM.build(tc, "cpu", page=PAGE), tp)
    return out


def inputs(dtype):
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (B, ST)).astype(np.int32)
    src = rng.standard_normal((B, SS, 64), dtype=np.float32)
    return ({"tokens": jnp.asarray(toks),
             "src_embeds": jnp.asarray(src).astype(JDT[dtype])},
            {"tokens": torch.from_numpy(toks),
             "src_embeds": torch.from_numpy(src).to(TDT[dtype])})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_forward_and_prefill_match(models, dtype):
    jc, tc, jm, jp, tm, tp = models[dtype]
    jb, tb = inputs(dtype)
    ltol = TOL[dtype][0]
    assert_close(TED.encode(tp, tc, tb["src_embeds"]),
                 JED.encode(jp, jc, jb["src_embeds"], remat=False), ltol)
    tl = tm.forward(tp, tb)
    assert tl.shape == (B, ST, tc.padded_vocab) and tl.dtype == torch.float32
    assert_close(tl, jm.forward(jp, jb, remat=False), ltol)
    jl, jcache = jm.prefill(jp, jb)
    tl1, tcache = tm.prefill(tp, tb)
    assert jcache is None and tcache is None
    assert_close(tl1, jl, ltol)
    assert_close(tl1, tl[:, -1:], 0.0)
    with pytest.raises(ValueError, match="fills no cache"):
        tm.prefill(tp, tb, tm.init_cache(B, CACHE))


def cross_kv(enc, cross_wk, cross_wv, cfg, matmul, empty):
    """Each decoder layer's cross K/V of the encoder output ``enc``
    [B,Ss,D], written into slots [0, Ss) of ``empty`` [L,B,n,K,hd]
    copies (numpy), the projections by ``matmul`` of the package."""
    K, hd = cfg.n_kv_heads, cfg.hd
    xk, xv = empty.copy(), empty.copy()
    for i in range(cfg.n_layers):
        xk[i, :, :SS] = f32(matmul(enc, cross_wk[i])).reshape(B, SS, K, hd)
        xv[i, :, :SS] = f32(matmul(enc, cross_wv[i])).reshape(B, SS, K, hd)
    return xk, xv


@pytest.mark.parametrize("filled", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches(models, dtype, filled):
    """4 greedy decode steps from position 0 over a cache of 48 positions,
    the cross cache zeros or the encoder's projection over 40 of them."""
    jc, tc, jm, jp, tm, tp = models[dtype]
    jb, tb = inputs(dtype)
    ltol, ctol = TOL[dtype]
    jcache = jm.init_cache(B, CACHE, JDT[dtype])
    tcache = tm.init_cache(B, CACHE, TDT[dtype])
    jdecode = jax.jit(jm.decode_step)
    if filled:
        zeros = np.zeros(jcache["xk"].shape, np.float32)
        enc = JED.encode(jp, jc, jb["src_embeds"], remat=False)
        jxk, jxv = cross_kv(enc, jp["dec"]["cross"]["wk"],
                            jp["dec"]["cross"]["wv"], jc, JL.matmul, zeros)
        jcache = dict(jcache, xk=jnp.asarray(jxk).astype(JDT[dtype]),
                      xv=jnp.asarray(jxv).astype(JDT[dtype]))
        enc = TED.encode(tp, tc, tb["src_embeds"])
        txk, txv = cross_kv(enc, [lp.cross.wk for lp in tp.dec],
                            [lp.cross.wv for lp in tp.dec], tc, TL.matmul,
                            zeros)
        tcache["xk"].copy_(torch.from_numpy(txk))
        tcache["xv"].copy_(torch.from_numpy(txv))
        assert_close(tcache["xk"], jcache["xk"], ctol)
    tok = np.array(jb["tokens"][:, :1])
    for i in range(4):
        pos = np.full(B, i, np.int32)
        jl, jcache = jdecode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        assert tl.shape == (B, 1, tc.padded_vocab)
        assert_close(tl, jl, ltol)
        for k in ("k", "v"):
            assert_close(tcache[k], jcache[k], ctol)
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_encdec_params_round_trip(models):
    jc, tc, _, jp, _, tp = models["bfloat16"]
    tree = jax.tree.map(np.asarray, jp)
    back = TM.params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    shapes = TM.param_shapes(tc)
    flat = {tuple(getattr(k, "key", k) for k in path): np.shape(a)
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}
    assert flat == shapes
