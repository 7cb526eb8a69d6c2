"""The port's dense model (granite-3-2b) against the JAX package's.

Parameters come from the JAX ``Model.init(PRNGKey(0))`` (or, for the
layer tests, from numpy draws) and are carried across by
``params_from_jax``; inputs are numpy draws from a seed.  The JAX side
runs on the CPU as its own tests run it; the port runs its plain path
(the attention kernels' plain versions).

Tolerances:
- float32 (the config's dtype replaced): 1e-4 on logits and caches.  The
  two sides add the same products in other orders (1e-6 measured).
- bfloat16: 4e-2 on logits, 6.25e-2 on caches.  bf16 rounds at other
  places in the two: the JAX model rounds its attention weights to bf16
  before the PV product (models/layers.py:144, :285), the port's plain
  versions keep them in float32 as the Pallas kernels do, and torch and
  XLA order their float32 sums differently.  Each such difference moves
  a bf16 activation by an ulp (2^-8 of its size); two layers carry that
  to the logits, whose spread was 1.6e-2 at logits of size ~1.2.  A
  cache entry of size 4-8 is one ulp (3.1e-2) off at most, measured; the
  bound allows two.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import layers as JL
from repro.models.model import build as jbuild
from repro.models.model import cross_entropy as jcross_entropy
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

ARCH = "granite-3-2b"
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (4e-2, 6.25e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_granite_fullwidth.json")


def cfgs(dtype="float32", **over):
    jc = dataclasses.replace(jget_smoke(ARCH), dtype=dtype, **over)
    tc = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=dtype,
                             **over)
    return jc, tc


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


def both(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(
        TDT[dtype])


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_config_copy_equals_the_reference(arch):
    j, t = jget_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.hd, j.padded_vocab, j.n_params()) == \
        (t.hd, t.padded_vocab, t.n_params())
    assert dataclasses.asdict(jget_smoke(arch)) == \
        dataclasses.asdict(tconfigs.get_smoke_config(arch))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "llama-3-8b"])
def test_unported_configs_raise(arch):
    """Every architecture of the reference is ported; a name outside its
    list raises, naming the list."""
    assert tuple(tconfigs.PORTED) == tuple(tconfigs.ARCHS)
    with pytest.raises(KeyError, match="recurrentgemma-2b"):
        tconfigs.get_config(arch)


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match(dtype):
    rng = np.random.default_rng(0)
    jx, tx = both(rng.standard_normal((2, 8, 4, 16), dtype=np.float32),
                  dtype)
    scale = rng.standard_normal(16).astype(np.float32)
    got = TL.rms_norm(TL.RMSNorm(scale=torch.from_numpy(scale)), tx, 1e-6)
    assert_close(got, JL.rms_norm({"scale": jnp.asarray(scale)}, jx, 1e-6),
                 TOL[dtype][0])
    pos = rng.integers(0, 4096, (2, 8)).astype(np.int32)
    got = TL.apply_rope(tx, torch.from_numpy(pos), 10_000.0)
    want = JL.apply_rope(jx, jnp.asarray(pos), 10_000.0)
    assert_close(got, want, TOL[dtype][0])


def layer_params(jcfg, seed=0):
    """JAX attn and mlp params (from their init) and the port's copies."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    ja, jm = JL.attn_init(k1, jcfg), JL.mlp_init(k2, jcfg)
    ta = TL.Attention(**{k: TM._tensor(np.asarray(v), TDT[jcfg.dtype], "cpu")
                         for k, v in ja.items()})
    tm = TL.MLP(**{k: TM._tensor(np.asarray(v), TDT[jcfg.dtype], "cpu")
                   for k, v in jm.items()})
    return ja, jm, ta, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_and_attn_apply_match(dtype):
    jc, tc = cfgs(dtype)
    ja, jm, ta, tm = layer_params(jc)
    rng = np.random.default_rng(1)
    jx, tx = both(rng.standard_normal((2, 24, 64), dtype=np.float32), dtype)
    assert_close(TL.mlp_apply(tm, tx), JL.mlp_apply(jm, jx), TOL[dtype][0])
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    out, (k, v) = TL.attn_apply(ta, tc, tx, torch.from_numpy(pos))
    jout, (jk, jv) = JL.attn_apply(ja, jc, jx, jnp.asarray(pos))
    assert_close(out, jout, TOL[dtype][0])
    assert_close(k, jk, TOL[dtype][1])
    assert_close(v, jv, TOL[dtype][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_decode_matches(dtype):
    """Ragged positions, so lens = pos + 1 differs per request; an
    off-by-one there shows only against the reference's mask."""
    jc, tc = cfgs(dtype)
    ja, _, ta, _ = layer_params(jc, seed=3)
    rng = np.random.default_rng(2)
    B, S, K, hd = 3, 32, tc.n_kv_heads, tc.hd
    jx, tx = both(rng.standard_normal((B, 1, 64), dtype=np.float32), dtype)
    jkc, tkc = both(rng.standard_normal((B, S, K, hd), dtype=np.float32),
                    dtype)
    jvc, tvc = both(rng.standard_normal((B, S, K, hd), dtype=np.float32),
                    dtype)
    pos = np.array([0, 17, 31], np.int32)
    out, kc, vc = TL.attn_decode(ta, tc, tx, torch.from_numpy(pos),
                                 tkc.clone(), tvc.clone(), page=8)
    jout, jkc2, jvc2 = JL.attn_decode(ja, jc, jx, jnp.asarray(pos), jkc, jvc)
    assert_close(out, jout, TOL[dtype][0])
    assert_close(kc, jkc2, TOL[dtype][1])
    assert_close(vc, jvc2, TOL[dtype][1])


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def jax_granite():
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc, tc = cfgs(dtype)
        m = jbuild(jc)
        params = m.init(jax.random.PRNGKey(0))
        out[dtype] = (jc, tc, m, params)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_granite_smoke_serving_matches_jax(jax_granite, dtype):
    """forward, prefill (logits and cache) and 4 greedy decode steps
    (logits and cache) of granite-3-2b's smoke config."""
    jc, tc, jm, jparams = jax_granite[dtype]
    tree = jax.tree.map(np.asarray, jparams)
    tparams = TM.params_from_jax(tree, tc, "cpu")
    tm = TM.build(tc, "cpu", page=16)
    ltol, ctol = TOL[dtype]
    B, S, CACHE = 2, 32, 48
    toks = np.random.default_rng(7).integers(0, tc.vocab_size, (B, S)
                                             ).astype(np.int32)
    assert_close(tm.forward(tparams, {"tokens": torch.from_numpy(toks)}),
                 jm.forward(jparams, {"tokens": jnp.asarray(toks)},
                            remat=False), ltol)

    jl, jpc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tpc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (B, 1, tc.padded_vocab) and tl.dtype == torch.float32
    assert_close(tl, jl, ltol)
    for k in ("k", "v"):
        assert tpc[k].shape == jpc[k].shape
        assert_close(tpc[k], jpc[k], ctol)

    cdt = JDT[dtype]
    jcache = jm.init_cache(B, CACHE, cdt)
    jcache = {k: jcache[k].at[:, :, :S].set(jpc[k].astype(cdt))
              for k in jcache}
    tcache = tm.init_cache(B, CACHE, TDT[dtype])
    tl2, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                             tcache)
    assert_close(tl2, tl, 0.0)
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for i in range(4):
        pos = np.full(B, S + i, np.int32)
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        assert_close(tl, jl, ltol)
        for k in ("k", "v"):
            assert_close(tcache[k], jcache[k], ctol)
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_params_round_trip(jax_granite):
    _, tc, _, jparams = jax_granite["bfloat16"]
    tree = jax.tree.map(np.asarray, jparams)
    back = TM.params_to_numpy(TM.params_from_jax(tree, tc, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_params_from_jax_copies_and_checks(jax_granite):
    _, tc, _, jparams = jax_granite["float32"]
    tree = jax.tree.map(lambda a: np.array(a), jparams)
    p = TM.params_from_jax(tree, tc, "cpu")
    tree["embed"]["tok"][0, 0] += 1.0
    assert float(p.embed.tok[0, 0]) != float(tree["embed"]["tok"][0, 0])
    tree["layers"]["attn"]["q_norm"] = tree["layers"]["ln1"]
    with pytest.raises(ValueError, match="q_norm"):
        TM.params_from_jax(tree, tc, "cpu")


def test_cross_entropy_matches():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    tgt = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.7).astype(np.float32)
    for m in (None, mask):
        got = TM.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(tgt),
                               None if m is None else torch.from_numpy(m))
        want = jcross_entropy(jnp.asarray(logits), jnp.asarray(tgt),
                              None if m is None else jnp.asarray(m))
        assert abs(float(got) - float(want)) < 1e-5


def test_entry_points_default_to_the_card():
    """With no card, naming no device raises instead of falling back."""
    _, tc = cfgs()
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.build(tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.params_from_jax({}, tc)


def test_unported_options_raise():
    """The page size must divide the cache (every family of the reference
    is ported; a family outside them raises)."""
    _, tc = cfgs()
    with pytest.raises(ValueError, match="unknown model family"):
        TM.build(dataclasses.replace(tc, family="retnet"), "cpu")
    m = TM.build(tc, "cpu", page=16)
    params = m.init(torch.Generator().manual_seed(0))
    cache = m.init_cache(1, 24, torch.float32)
    with pytest.raises(ValueError, match="multiple of the page"):
        m.decode_step(params, cache, torch.zeros(1, 1, dtype=torch.int32),
                      torch.zeros(1, dtype=torch.int32))


def test_init_and_dummy_batch_follow_the_generator():
    _, tc = cfgs()
    m = TM.build(tc, "cpu")
    a = m.init(torch.Generator().manual_seed(1))
    b = m.init(torch.Generator().manual_seed(1))
    shapes = TM.param_shapes(tc)
    tree = TM.params_to_numpy(a)
    for path, shape in shapes.items():
        leaf = tree
        for k in path:
            leaf = leaf[k]
        assert leaf.shape == shape
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    bt = TM.dummy_batch(tc, 2, 8, torch.Generator().manual_seed(2))["tokens"]
    assert bt.shape == (2, 8) and bt.dtype == torch.int32
    assert int(bt.max()) < tc.vocab_size


def test_full_width_snapshot_on_the_cpu():
    """The port's plain path at granite-3-2b's full width (2 layers)
    against the JAX snapshot chip_smoke.py checks the card against: the
    digests of this checkout's numpy draws first, then the logits (the
    bf16 tolerance the snapshot states, 2e-2), with the snapshot's greedy
    tokens fed back."""
    with open(GOLDEN) as f:
        snap = json.load(f)
    cfg = dataclasses.replace(tconfigs.get_config(ARCH),
                              n_layers=snap["n_layers"])
    tree = TM.numpy_params(cfg, snap["seed"])
    assert TM.tree_sha256(tree) == snap["weights_sha256"]
    B, S = snap["batch"], snap["prompt_len"]
    prompt = np.random.default_rng(snap["seed"] + 1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    assert TM.tree_sha256({}, prompt) == snap["prompt_sha256"]
    m = TM.build(cfg, "cpu")
    params = TM.params_from_jax(tree, cfg, "cpu")
    del tree
    logits, cache = m.prefill(params, {"tokens": torch.from_numpy(prompt)},
                              m.init_cache(B, snap["cache_len"]))
    for i, st in enumerate(snap["steps"]):
        if i:
            tok = torch.tensor(snap["steps"][i - 1]["token"],
                               dtype=torch.int32)[:, None]
            logits, cache = m.decode_step(
                params, cache, tok, torch.full((B,), S + i - 1,
                                               dtype=torch.int32))
        lg = logits[:, -1]
        got = torch.gather(lg, 1, torch.tensor(st["top_ids"])).numpy()
        np.testing.assert_allclose(got, st["top_logits"], atol=2e-2)
        np.testing.assert_allclose(torch.logsumexp(lg, -1).numpy(),
                                   st["logsumexp"], atol=2e-2)
        for b in range(B):
            if st["margin"][b] > 2e-2:
                assert int(lg[b].argmax()) == st["token"][b]
