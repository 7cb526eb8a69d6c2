"""The port's MoE FFN and moe models (granite-moe-1b-a400m, mixtral-8x7b)
against the JAX package's.

Parameters come from the JAX initialisers and are carried across by
``params_from_jax`` (``TM._tensor`` for a layer alone); inputs are numpy
draws from a seed.  The JAX side runs on the CPU as its own tests run
it; the port runs its plain path.

Routes (the experts chosen, kept or dropped, and their slots) have no
tolerance: ``moe.route`` must make the reference's decisions, which the
oracle here recomputes with the reference's own lines
(``src/repro/models/moe.py:45-61``).  The cases include rows of zeros,
whose gates all tie (``lax.top_k`` takes the lower experts first), a
group where experts overflow their capacity, and a decode group of B =
2 where C = 1 drops the second request's shared experts.

Tolerances:
- float32: 1e-5 on ``moe_apply`` (the two add the same <= k products in
  other orders), 1e-4 on the models' logits and caches, as the dense
  tests (tests/test_torch_model.py).
- bfloat16, ``moe_apply`` on identical inputs: the dense tests' 4e-2.
  The experts' roundings are the reference's, place for place.

The models are compared in float32 only.  In bf16 the two packages'
attention rounds at other places (tests/test_torch_model.py), which
moves a router's gates by ~1e-3 at this width; a token whose k-th and
(k+1)-th gates lie closer than that can take another expert, which moves
its output by a whole expert's share and, through capacity, the routes
of the tokens after it.  Measured here: at granite-moe's smoke prefill
two near ties (gaps 1.9e-3 and 2.8e-3) flipped and moved 11 of the 64
positions' logits by up to 0.6.  The bf16 models are checked at full
width against the JAX snapshot on the card instead (``chip_smoke.py``
phase 14), with requests under a gate gap left out and counted.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models.model import build as jbuild
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

TOL = {"float32": (1e-4, 1e-4), "bfloat16": (4e-2, 6.25e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cfgs(arch, dtype="float32", **over):
    jc = dataclasses.replace(jget_smoke(arch), dtype=dtype, **over)
    tc = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=dtype,
                             **over)
    return jc, tc


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


def jax_routes(p, x, cfg):
    """The reference's routing decisions, its own lines
    (repro/models/moe.py:36-61): (topi, topv, keep, slot) per (token,
    choice), slot the capacity position where kept."""
    B, S, _ = x.shape
    M = min(JMOE.GROUP, B * S)
    C = min(max(int(cfg.capacity_factor * M * cfg.top_k / cfg.n_experts),
                1), M)
    topi, topv, pos = _jax_routes(p, x, cfg)
    keep = np.asarray(pos) < C
    return (np.asarray(topi), np.asarray(topv), keep,
            np.where(keep, np.asarray(pos), -1).astype(np.int64), C)


@functools.partial(jax.jit, static_argnums=2)
def _jax_routes(p, x, cfg):
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    M = min(JMOE.GROUP, B * S)
    G = B * S // M
    xg = x.reshape(G, M, D)
    gates = jax.nn.softmax(
        JL.einsum_f32("gmd,de->gme", xg.astype(jnp.float32), p["router"]), -1)
    topv, topi = jax.lax.top_k(gates, k)
    topv = topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(topi, E, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(G, M * k, E), axis=1)
    pos = (pos.reshape(G, M, k, E) * onehot - 1.0) * onehot
    return topi, topv, pos.sum(-1)                      # pos [G,M,k]


def moe_params(jc, seed=0):
    jp = JMOE.moe_init(jax.random.PRNGKey(seed), jc)
    tp = TL.MoE(**{k: TM._tensor(np.asarray(v), TM._leaf_dtype((k,), jc),
                                 "cpu") for k, v in jp.items()})
    return jp, tp


# (arch, B, S, zero rows): one group of 512 (granite-moe: 8 experts, top
# 2, C = 160) with 200 rows of zeros that all pick experts 0 and 1 and
# overflow them; two groups of 512 (mixtral: 4 experts, top 2); decode
# groups of B = 2 (C = 1), both requests alike (the second loses both
# its experts) or the first alone zero
CASES = [("granite-moe-1b-a400m", 2, 256, 200),
         ("mixtral-8x7b", 4, 256, 0),
         ("granite-moe-1b-a400m", 2, 1, 2),
         ("mixtral-8x7b", 2, 1, 1)]


@pytest.mark.parametrize("arch,B,S,zeros", CASES)
def test_routes_equal_the_reference(arch, B, S, zeros):
    jc, tc = cfgs(arch)
    jp, tp = moe_params(jc)
    x = np.random.default_rng(0).standard_normal(
        (B, S, tc.d_model), dtype=np.float32)
    x.reshape(B * S, -1)[:zeros] = 0.0
    topi, topv, keep, slot, C = jax_routes(jp, jnp.asarray(x), jc)
    r = TMOE.route(tp, torch.from_numpy(x), tc)
    assert r.C == C
    np.testing.assert_array_equal(r.topi.numpy(), topi)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(np.where(keep, r.pos.numpy(), -1), slot)
    np.testing.assert_allclose(r.topv.numpy(), topv, atol=1e-6)
    # ties: the lower experts first
    assert (r.topi.reshape(B * S, -1)[:zeros].numpy()
            == np.arange(tc.top_k)).all()
    if zeros > C:   # experts 0 and 1 overflow: the first C rows keep them
        assert keep.reshape(B * S, -1)[:C].all()
        assert not keep.reshape(B * S, -1)[C:zeros].any()
    if S == 1:      # decode: one group of B tokens
        assert C == 1


@pytest.mark.parametrize("arch,B,S,zeros", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches(arch, B, S, zeros, dtype):
    jc, tc = cfgs(arch, dtype)
    jp, tp = moe_params(jc, seed=1)
    x = np.random.default_rng(2).standard_normal(
        (B, S, tc.d_model), dtype=np.float32)
    x.reshape(B * S, -1)[:zeros] = 0.0
    got = TMOE.moe_apply(tp, torch.from_numpy(x).to(TDT[dtype]), tc)
    want = jax.jit(JMOE.moe_apply, static_argnums=2)(
        jp, jnp.asarray(x).astype(JDT[dtype]), jc)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, tc.d_model)
    assert_close(got, want, 1e-5 if dtype == "float32" else TOL[dtype][0])


def test_moe_refuses_a_ragged_group():
    _, tc = cfgs("mixtral-8x7b")
    _, tp = moe_params(cfgs("mixtral-8x7b")[0])
    with pytest.raises(ValueError, match="routing groups"):
        TMOE.moe_apply(tp, torch.zeros(3, 200, tc.d_model), tc)


# ---------------------------------------------------------------- models


@pytest.fixture(scope="module")
def jax_models():
    out = {}
    for arch in ("granite-moe-1b-a400m", "mixtral-8x7b"):
        jc, tc = cfgs(arch)
        m = jbuild(jc)
        out[arch] = (jc, tc, m, jax.jit(m.init)(jax.random.PRNGKey(0)))
    return out


def _serve(jax_models, arch, S, steps, cache_len, forward=True):
    """forward (unless told not to), prefill (logits and cache) and greedy
    decode steps of a smoke model in both packages, each step's logits
    and cache held to the tolerance; the decode cache is the prefill's,
    copied into ``init_cache(B, cache_len)`` on the JAX side and filled
    in place on the port's."""
    jc, tc, jm, jparams = jax_models[arch]
    dtype = "float32"
    tparams = TM.params_from_jax(jax.tree.map(np.asarray, jparams), tc,
                                 "cpu")
    tm = TM.build(tc, "cpu", page=16)
    jforward = jax.jit(lambda p, b: jm.forward(p, b, remat=False))
    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    ltol, ctol = TOL[dtype]
    B = 2
    toks = np.random.default_rng(7).integers(0, tc.vocab_size, (B, S)
                                             ).astype(np.int32)
    if forward:
        assert_close(tm.forward(tparams, {"tokens": torch.from_numpy(toks)}),
                     jforward(jparams, {"tokens": jnp.asarray(toks)}), ltol)
    jl, jpc = jprefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tpc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    assert_close(tl, jl, ltol)
    for k in ("k", "v"):
        assert tpc[k].shape == jpc[k].shape
        assert_close(tpc[k], jpc[k], ctol)
    cdt = JDT[dtype]
    jcache = jm.init_cache(B, cache_len, cdt)
    n = jpc["k"].shape[2]
    jcache = {k: jcache[k].at[:, :, :n].set(jpc[k].astype(cdt))
              for k in jcache}
    tl2, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                             tm.init_cache(B, cache_len, TDT[dtype]))
    assert_close(tl2, tl, 0.0)
    assert tcache["k"].shape == jcache["k"].shape
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for i in range(steps):
        pos = np.full(B, S + i, np.int32)
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(tok),
                             jnp.asarray(pos))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        assert_close(tl, jl, ltol)
        for k in ("k", "v"):
            assert_close(tcache[k], jcache[k], ctol)
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_granite_moe_smoke_serving_matches_jax(jax_models):
    """Prefill 2 x 32 (one routing group), 4 decode steps (groups of B =
    2, C = 1) over a cache of 48."""
    _serve(jax_models, "granite-moe-1b-a400m", 32, 4, 48)


@pytest.mark.parametrize("S,steps", [(28, 6), (40, 4)])
def test_mixtral_ring_matches_jax(jax_models, S, steps):
    """mixtral's smoke config (window 32, a ring of 32 slots in pages of
    16): a prompt of 28 decoded across the wrap at position 32, and a
    prompt of 40 that overflows the ring at prefill (its last 32 keys at
    slots 0..31) decoded on from there."""
    _serve(jax_models, "mixtral-8x7b", S, steps, 64, forward=S == 40)


def test_moe_params_cross_and_draw():
    """The moe leaves cross both ways (router float32, experts bf16) and
    keep the reference's shapes; numpy_params draws an expert tensor with
    the reference's fan-in (D for wi/wg, F for wo)."""
    jc, tc = cfgs("granite-moe-1b-a400m", "bfloat16")
    tree = TM.numpy_params(tc, 1)
    back = TM.params_to_numpy(TM.params_from_jax(tree, tc, "cpu"))
    shapes = jax.eval_shape(jbuild(jc).init, jax.random.PRNGKey(0))
    assert jax.tree.structure(back) == jax.tree.structure(shapes)
    for (path, a), b, want in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert (a.shape, a.dtype) == (want.shape, want.dtype), path
        np.testing.assert_array_equal(a, b.astype(want.dtype))
    assert back["layers"]["ffn"]["router"].dtype == np.float32
    cfg = dataclasses.replace(tc, d_model=256, d_ff=64, n_experts=16)
    ffn = TM.numpy_params(cfg, 0)["layers"]["ffn"]
    for name, fan_in in (("wi", 256), ("wg", 256), ("wo", 64),
                         ("router", 256)):
        assert abs(float(np.std(ffn[name])) * np.sqrt(fan_in) - 1) < 0.02
