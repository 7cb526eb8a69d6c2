"""The attention options and the dense configs the port gained with them
against the JAX package: qk_norm (qwen3-32b), sliding windows (the ring
cache; mixtral-8x7b's models are in tests/test_torch_moe.py), M-RoPE
with vision embeddings (qwen2-vl-7b), and phi3-medium-14b and yi-6b.

Parameters come from the JAX initialisers and are carried across by
``params_from_jax`` (``TM._tensor`` for a layer alone); inputs are numpy
draws from a seed.  The JAX side runs on the CPU as its own tests run
it; the port runs its plain path.

Tolerances, as the dense tests (tests/test_torch_model.py): float32 1e-4
on activations, logits and caches (the same products summed in other
orders); bfloat16 4e-2 on a layer's outputs, 6.25e-2 on caches (bf16
rounds at other places in the two's attention).  bf16 logits: 8e-2.
These configs have an untied head, so their smoke logits reach ~4.1
(granite-3-2b's tied ones ~1.2), where a bf16 ulp is 3.1e-2: measured,
qwen2-vl-7b's and qwen3-32b's bf16 logits lie 6.0e-2 and 6.1e-2 from
the reference's own float32 ones, the port's 5.5e-2 and 7.2e-2, and the
two packages' bf16 logits 5.0e-2 and 5.1e-2 from each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import layers as JL
from repro.models.model import build as jbuild
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

TOL = {"float32": (1e-4, 1e-4), "bfloat16": (4e-2, 6.25e-2)}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 8e-2}
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


def both(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(
        TDT[dtype])


def attn_params(jc, seed=0):
    """The reference's attention init and the port's copy (q_norm and
    k_norm with qk_norm; the scales drawn, not ones, so that they
    matter)."""
    ja = JL.attn_init(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    for n in ("q_norm", "k_norm"):
        if n in ja:
            ja[n] = {"scale": jnp.asarray(
                rng.uniform(0.5, 1.5, jc.hd).astype(np.float32))}
    kw = {k: TM._tensor(np.asarray(v), TDT[jc.dtype], "cpu")
          for k, v in ja.items() if k.startswith("w")}
    norms = {n: TL.RMSNorm(scale=torch.from_numpy(np.array(ja[n]["scale"])))
             for n in ("q_norm", "k_norm") if n in ja}
    return ja, TL.Attention(**kw, **norms)


# ---------------------------------------------------------------- layers


def positions3_of(B, S, P, grid):
    """M-RoPE streams [3,B,S]: P vision patches on a grid-wide raster at
    t = 0 (h = i // grid, w = i % grid), then text at t = h = w counting
    on from max(h, w) + 1, as qwen2-vl numbers them."""
    pos = np.zeros((3, B, S), np.int32)
    i = np.arange(P)
    pos[1, :, :P], pos[2, :, :P] = i // grid, i % grid
    text = np.arange(S - P) + max(pos[1:, :, :P].max(), 0) + 1
    pos[:, :, P:] = text
    return pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches(dtype):
    jc, tc = cfgs("qwen2-vl-7b", dtype)
    rng = np.random.default_rng(0)
    jx, tx = both(rng.standard_normal((2, 12, 4, tc.hd), dtype=np.float32),
                  dtype)
    p3 = positions3_of(2, 12, 6, 3)
    got = TL.apply_mrope(tx, torch.from_numpy(p3), tc.rope_theta,
                         tc.mrope_sections)
    want = JL.apply_mrope(jx, jnp.asarray(p3), jc.rope_theta,
                          jc.mrope_sections)
    assert_close(got, want, TOL[dtype][0])


# (arch, options): qk_norm; a window shorter than the sequence; M-RoPE
ATTN_CASES = [("qwen3-32b", {}), ("yi-6b", {"window": 8}),
              ("qwen2-vl-7b", {})]


@pytest.mark.parametrize("arch,over", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_apply_and_decode_take_the_options(arch, over, dtype):
    """attn_apply over 24 positions, then attn_decode at ragged positions
    over a cache of 32 (a ring of 8 with the window: positions past it
    wrap), against the reference's two functions."""
    jc, tc = cfgs(arch, dtype, **over)
    ja, ta = attn_params(jc)
    ltol, ctol = TOL[dtype]
    rng = np.random.default_rng(1)
    B, S, D = 2, 24, tc.d_model
    jx, tx = both(rng.standard_normal((B, S, D), dtype=np.float32), dtype)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    p3 = positions3_of(B, S, 6, 3) if tc.mrope_sections else None
    kw = {} if p3 is None else {"positions3": p3}
    out, (k, v) = TL.attn_apply(
        ta, tc, tx, torch.from_numpy(pos), window=tc.window,
        **{n: torch.from_numpy(a) for n, a in kw.items()})
    jout, (jk, jv) = jax.jit(JL.attn_apply, static_argnames=(
        "cfg", "window"))(ja, jc, jx, jnp.asarray(pos), window=jc.window,
                          **{n: jnp.asarray(a) for n, a in kw.items()})
    assert_close(out, jout, ltol)
    assert_close(k, jk, ctol)
    assert_close(v, jv, ctol)

    n = min(32, tc.window or 32)
    K, hd = tc.n_kv_heads, tc.hd
    jxd, txd = both(rng.standard_normal((3, 1, D), dtype=np.float32), dtype)
    jkc, tkc = both(rng.standard_normal((3, n, K, hd), dtype=np.float32),
                    dtype)
    jvc, tvc = both(rng.standard_normal((3, n, K, hd), dtype=np.float32),
                    dtype)
    p = np.array([0, 5, 29], np.int32)
    kw = {}
    if tc.mrope_sections:
        kw = {"positions3": np.stack([p[:, None], p[:, None] + 1,
                                      p[:, None] + 2])}
    got, kc, vc = TL.attn_decode(
        ta, tc, txd, torch.from_numpy(p), tkc.clone(), tvc.clone(), page=8,
        window=tc.window, **{n: torch.from_numpy(a) for n, a in kw.items()})
    want, jkc2, jvc2 = jax.jit(JL.attn_decode, static_argnames=(
        "cfg", "window"))(ja, jc, jxd, jnp.asarray(p), jkc, jvc,
                          window=jc.window,
                          **{n: jnp.asarray(a) for n, a in kw.items()})
    assert_close(got, want, ltol)
    assert_close(kc, jkc2, ctol)
    assert_close(vc, jvc2, ctol)


def test_cross_attention_takes_no_rotation_and_no_mask():
    """attn_apply with ``kv``: S != Sk, no rope, not causal."""
    jc, tc = cfgs("seamless-m4t-medium")
    ja, ta = attn_params(jc)
    rng = np.random.default_rng(2)
    jx, tx = both(rng.standard_normal((2, 12, 64), dtype=np.float32),
                  "float32")
    jkv, tkv = both(rng.standard_normal((2, 20, 64), dtype=np.float32),
                    "float32")
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    spos = np.broadcast_to(np.arange(20), (2, 20)).astype(np.int32)
    out, (k, _) = TL.attn_apply(ta, tc, tx, torch.from_numpy(pos), kv=tkv)
    jout, (jk, _) = JL.attn_apply(ja, jc, jx, jnp.asarray(pos), kv=jkv,
                                  kv_positions=jnp.asarray(spos))
    assert k.shape == (2, 20, tc.n_kv_heads, tc.hd)
    assert_close(out, jout, TOL["float32"][0])
    assert_close(k, jk, TOL["float32"][1])


def test_a_ring_larger_than_the_window_is_refused():
    _, tc = cfgs("mixtral-8x7b")
    ta = attn_params(cfgs("mixtral-8x7b")[0])[1]
    cache = torch.zeros(1, 64, tc.n_kv_heads, tc.hd)
    with pytest.raises(ValueError, match="ring"):
        TL.attn_decode(ta, tc, torch.zeros(1, 1, tc.d_model),
                       torch.zeros(1, dtype=torch.int32), cache,
                       cache.clone(), page=16, window=tc.window)


# ---------------------------------------------------------------- models


def serve_both(arch, dtype, batch_extras=None, decode_extras=None, S=24,
               steps=2, cache_len=32):
    """Prefill (logits and cache) and greedy decode steps of a smoke model
    in both packages from the same JAX init, every step held to the
    tolerance.  ``batch_extras`` (numpy) join the batch;
    ``decode_extras(i, pos)`` give a step's extras (None: none)."""
    jc, tc = cfgs(arch, dtype)
    jm = jbuild(jc)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tparams = TM.params_from_jax(jax.tree.map(np.asarray, jparams), tc,
                                 "cpu")
    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    tm = TM.build(tc, "cpu", page=16)
    ltol, ctol = LOGIT_TOL[dtype], TOL[dtype][1]
    B = 2
    toks = np.random.default_rng(7).integers(0, tc.vocab_size, (B, S)
                                             ).astype(np.int32)
    extras = batch_extras or {}
    jb = {"tokens": jnp.asarray(toks),
          **{k: jnp.asarray(v) for k, v in extras.items()}}
    tb = {"tokens": torch.from_numpy(toks),
          **{k: torch.from_numpy(v) for k, v in extras.items()}}
    jl, jpc = jprefill(jparams, jb)
    tl, tcache = tm.prefill(tparams, tb, tm.init_cache(B, cache_len,
                                                       TDT[dtype]))
    assert_close(tl, jl, ltol)
    jcache = jm.init_cache(B, cache_len, JDT[dtype])
    jcache = {k: jcache[k].at[:, :, :S].set(jpc[k].astype(JDT[dtype]))
              for k in jcache}
    for k in ("k", "v"):
        assert_close(tcache[k], jcache[k], ctol)
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for i in range(steps):
        pos = np.full(B, S + i, np.int32)
        ex = decode_extras(i, pos) if decode_extras else None
        jl, jcache = jdecode(
            jparams, jcache, jnp.asarray(tok), jnp.asarray(pos),
            None if ex is None else {k: jnp.asarray(v)
                                     for k, v in ex.items()})
        tl, tcache = tm.decode_step(
            tparams, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
            None if ex is None else {k: torch.from_numpy(v)
                                     for k, v in ex.items()})
        assert_close(tl, jl, ltol)
        for k in ("k", "v"):
            assert_close(tcache[k], jcache[k], ctol)
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


@pytest.mark.parametrize("arch,dtype", [("qwen3-32b", "float32"),
                                        ("qwen3-32b", "bfloat16"),
                                        ("phi3-medium-14b", "float32"),
                                        ("yi-6b", "float32")])
def test_dense_smoke_serving_matches_jax(arch, dtype):
    serve_both(arch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen2_vl_serving_matches_jax(dtype):
    """Prefill with 6 vision embeddings in place of the first rows and
    their M-RoPE grid positions; decode a step with no extras (the
    default t = h = w = pos), then one with ``positions3`` given (text
    positions offset from the vision grid's, so that M-RoPE differs from
    RoPE)."""
    rng = np.random.default_rng(3)
    B, S, P = 2, 24, 6
    batch = {"vision_embeds": rng.standard_normal((B, P, 64),
                                                  dtype=np.float32) * 0.5,
             "positions3": positions3_of(B, S, P, 3)}

    def extras(i, pos):
        if i == 0:
            return None
        return {"positions3": np.stack([pos[:, None], pos[:, None] - 20,
                                        pos[:, None] - 19])}
    serve_both("qwen2-vl-7b", dtype, batch, extras)


def test_every_architecture_but_hybrid_builds():
    """get_config and Model(cfg, "cpu") for the nine ported architectures
    (their full configs, equal to the reference's); recurrentgemma-2b
    raises, naming the ROADMAP item that brings it."""
    assert set(tconfigs.ARCHS) - set(tconfigs.PORTED) == {"recurrentgemma-2b"}
    for arch in tconfigs.PORTED:
        cfg = tconfigs.get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jget_config(arch))
        assert TM.build(cfg, "cpu").cfg is cfg
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, Models"):
        tconfigs.get_config("recurrentgemma-2b")


def test_dummy_batch_draws_the_stub_inputs():
    g = torch.Generator().manual_seed(0)
    _, vc = cfgs("qwen2-vl-7b")
    b = TM.dummy_batch(vc, 2, 16, g)
    assert b["vision_embeds"].shape == (2, min(vc.n_patches, 8), 64)
    assert b["positions3"].shape == (3, 2, 16)
    assert (b["positions3"] == torch.arange(16)).all()
    _, ec = cfgs("seamless-m4t-medium")
    b = TM.dummy_batch(ec, 2, 16, g)
    assert b["src_embeds"].shape == (2, 16, 64)
    assert b["src_embeds"].abs().max() < 0.2 and b["src_embeds"].std() > 0
