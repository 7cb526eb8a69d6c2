"""The port's mamba2 family (mamba2-2.7b) against the JAX package's.

Inputs are numpy draws from a seed; model parameters come from the JAX
``Model.init(PRNGKey(0))`` and are carried across by ``params_from_jax``.
The JAX side runs on the CPU as its own tests run it (the Pallas kernel in
interpret mode); the port runs its plain path (the ssd_intra kernel's
plain version, ``kernels.ref.ssd_intra_plain``).

Tolerances:
- The intra-chunk block against the Pallas kernel: that kernel test's own
  (``tests/test_kernels_ssd.py``): 1e-4 in float32, 5e-2 in bf16.
- The ``model`` rounding against the reference's ``ssd_chunked``, and
  everything built on it, in float32: 1e-4 (the two sides sum the same
  products in other orders; 2.4e-6 measured on the smoke model's logits).
- bf16, set from the spread measured on a CPU before any card run:
  6.25e-2 on the model's logits and caches (3.5e-2 measured on logits of
  size ~4.5, where a bf16 ulp is 3.1e-2; 2.3e-2 on the conv cache) and on
  the mixer's outputs and states, and 5e-2 (the kernel test's) on the
  SSD block's.  bf16 rounds at the same places on both sides, but torch
  and XLA order their float32 sums differently, so a value can land one
  ulp off, and two layers carry that on.
- The chunked forward against the token-by-token recurrence, float32:
  1e-3, ``test_kernels_ssd.py:59``'s bound for the same identity.
- The full-width snapshot (bf16 logits of size ~4, where a bf16 ulp is
  3.1e-2): 5e-2 on the top-8 logits and the logsumexp; 2.1e-2 measured
  for the port's plain path on a CPU.
- The tensor-core kernel's split of B * w into two bf16 (hi, lo): exact;
  S summed through it against the plain version's: the float32
  summation bound 4 q 2^-24 sum_j |B w| |x|.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as JS
from repro.models.model import build as jbuild
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS

ARCH = "mamba2-2.7b"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 6.25e-2}
RECURRENT_TOL = 1e-3
SNAP_TOL = 5e-2
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_mamba2_fullwidth.json")
# tests/test_kernels_ssd.py's shapes (T, q, R, p, n)
KERNEL_SHAPES = [(2, 32, 4, 16, 16), (1, 64, 2, 32, 32), (3, 16, 8, 8, 16)]


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


def both(a: np.ndarray, dtype: str):
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype]))


def ssd_inputs(T, q, R, p, n, G, seed=0):
    """x [T,q,R,p]; dt, dA [T,q,R] (float32, as test_kernels_ssd.py
    draws them); B, C [T,q,G,n]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, q, R, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((T, q, R)))).astype(np.float32)
    dA = (-dt * np.exp(rng.standard_normal((1, 1, R)) * 0.3)).astype(
        np.float32)
    B = rng.standard_normal((T, q, G, n), dtype=np.float32)
    C = rng.standard_normal((T, q, G, n), dtype=np.float32)
    return x, dt, dA, B, C


# ---------------------------------------------------------------- the block


@pytest.mark.parametrize("T,q,R,p,n", KERNEL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_intra_matches_the_pallas_kernel(T, q, R, p, n, dtype):
    """ops.ssd_intra (the Pallas contract, B and C per head) against the
    Pallas kernel in interpret mode, and one (chunk, head) of each
    against the per-block references."""
    x, dt, dA, B, C = ssd_inputs(T, q, R, p, n, R)
    jx, tx = both(x, dtype)
    jB, tB = both(B, dtype)
    jC, tC = both(C, dtype)
    jy, jS = jops.ssd_intra(jx, jnp.asarray(dt[..., None]),
                            jnp.asarray(dA[..., None]), jB, jC)
    ty, tS = tops.ssd_intra(tx, torch.from_numpy(dt[..., None]),
                            torch.from_numpy(dA[..., None]), tB, tC)
    assert ty.dtype == tS.dtype == TDT[dtype]
    assert ty.shape == (T, q, R, p) and tS.shape == (T, R, n, p)
    tol = KERNEL_TOL[dtype]
    assert_close(ty, jy, tol)
    assert_close(tS, jS, tol)
    t, h = T - 1, R - 1
    ry, rS = tref.ssd_intra_reference(
        tx[t, :, h], torch.from_numpy(dt[t, :, h]),
        torch.from_numpy(dA[t, :, h]), tB[t, :, h], tC[t, :, h])
    jry, jrS = jref.ssd_intra_reference(
        jx[t, :, h], jnp.asarray(dt[t, :, h]), jnp.asarray(dA[t, :, h]),
        jB[t, :, h], jC[t, :, h])
    assert_close(ry, jry, tol)
    assert_close(rS, jrS, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_rounding_matches_ssd_chunked_intra_block(dtype):
    """The ``model`` rounding, B and C per group, against the reference's
    intra-chunk block: ``repro.models.ssm.ssd_chunked`` over sequences of
    one chunk each, whose y is y_intra and whose final state is S_loc
    (both cast to x's dtype there)."""
    T, q, G, r, p, n = 3, 16, 2, 3, 8, 16
    x, dt, dA, B, C = ssd_inputs(T, q, G * r, p, n, G, seed=1)
    A = (dA[0, 0] / dt[0, 0]).reshape(G, r)
    dA = (dt.reshape(T, q, G, r) * A).reshape(T, q, G * r)
    jx, tx = both(x, dtype)
    jB, tB = both(B, dtype)
    jC, tC = both(C, dtype)
    jy, jS = JS.ssd_chunked(jx.reshape(T, q, G, r, p),
                            jnp.asarray(dt.reshape(T, q, G, r)),
                            jnp.asarray(A), jB, jC, q)
    ty, tS = ssd_scan.ssd_intra(tx, torch.from_numpy(dt),
                                torch.from_numpy(dA), tB, tC, mode="model")
    assert ty.dtype == tS.dtype == torch.float32
    tol = KERNEL_TOL[dtype]
    assert_close(ty.to(TDT[dtype]), jy.reshape(T, q, G * r, p), tol)
    assert_close(tS.to(TDT[dtype]), jS.reshape(T, G * r, n, p), tol)
    if dtype == "float32":  # the two roundings are one computation here
        py, pS = ssd_scan.ssd_intra(tx, torch.from_numpy(dt),
                                    torch.from_numpy(dA), tB, tC)
        assert torch.equal(py, ty) and torch.equal(pS, tS)


def test_ssd_intra_refuses_what_it_cannot_take():
    x, dt, dA, B, C = (torch.from_numpy(a) for a in
                       ssd_inputs(1, 8, 4, 8, 8, 2))
    with pytest.raises(ValueError, match="multiple of 3 groups"):
        ssd_scan.ssd_intra(x, dt, dA, B.repeat(1, 1, 2, 1)[:, :, :3],
                           C.repeat(1, 1, 2, 1)[:, :, :3])
    with pytest.raises(TypeError, match="float32"):
        ssd_scan.ssd_intra(x, dt.double(), dA, B, C)
    with pytest.raises(TypeError, match="x is"):
        ssd_scan.ssd_intra(x, dt, dA, B.bfloat16(), C)
    with pytest.raises(ValueError, match="do not fit"):
        ssd_scan.ssd_intra(x, dt[:, :4], dA, B, C)
    with pytest.raises(ValueError, match="mode"):
        ssd_scan.ssd_intra(x, dt, dA, B, C, mode="tpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan.launch(x, dt, dA, B, C)


def _mamba2_operands(T=1, dtype=torch.bfloat16):
    """x, B and C as ``ssm_apply`` views them in mamba2-2.7b's convolution
    output (token stride conv_dim), and the y and S the wrapper makes."""
    cfg = tconfigs.get_config(ARCH)
    G, N, H, P, q = (cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_headdim, cfg.ssm_chunk)
    di = cfg.d_inner
    xbc = torch.zeros((1, T * q, di + 2 * G * N), dtype=dtype)
    x, B, C = torch.split(xbc, [di, G * N, G * N], dim=-1)
    x = x.view(1, T * q, G, H // G, P).view(T, q, H, P)
    B, C = B.view(T, q, G, N), C.view(T, q, G, N)
    y = torch.empty((T, q, H, P))
    S = torch.empty((T, H, N, P))
    return x, B, C, y, S


def _route(x, B, C, y, S, mode="model", ptr_shift=0):
    T, q, R, p = x.shape
    return ssd_scan.kernel_for(
        x.dtype, mode, q, B.shape[3], p,
        [t.stride(d) for t in (x, B, C, y, S) for d in (0, 1, 2)],
        [(t.data_ptr() + ptr_shift) % 16 for t in (x, B, C, y, S)])


@pytest.mark.parametrize("dtype,mode,want", [
    (torch.bfloat16, "model", "mma_bf16"),   # the mamba2 prefill's call
    (torch.bfloat16, "pallas", "fma_f32"),   # float32 weights
    (torch.float32, "model", "fma_f32"),
    (torch.float32, "pallas", "fma_f32")])
def test_kernel_for_routes_mamba2s_call(dtype, mode, want):
    x, B, C, y, S = _mamba2_operands(dtype=dtype)
    assert x.stride(1) == B.stride(1) == 5376  # conv_dim: 16-byte rows
    assert _route(x, B, C, y, S, mode) == want


@pytest.mark.parametrize("q,n,p,want", [
    (128, 128, 64, "mma_bf16"), (100, 40, 24, "mma_bf16"),
    (8, 16, 16, "mma_bf16"), (1, 8, 8, "mma_bf16"),
    (40, 36, 20, "fma_f32"), (64, 128, 20, "fma_f32"),
    (64, 36, 64, "fma_f32")])
def test_kernel_for_routes_shapes(q, n, p, want):
    """bf16 ``model`` calls go to the tensor cores while n and p are whole
    8-element chunks (any q: the tiles are zero-filled), else to the FMA
    kernel."""
    R = 2
    x = torch.zeros((1, q, R, p), dtype=torch.bfloat16)
    B = C = torch.zeros((1, q, 1, n), dtype=torch.bfloat16)
    y, S = torch.empty((1, q, R, p)), torch.empty((1, R, n, p))
    assert _route(x, B, C, y, S) == want


def test_kernel_for_refuses_what_neither_kernel_takes():
    x, B, C, y, S = _mamba2_operands()
    with pytest.raises(ValueError, match="16-byte aligned"):
        _route(x, B, C, y, S, ptr_shift=2)
    xbc = torch.zeros((1, 128, 5377), dtype=torch.bfloat16)
    xo = xbc[..., :5120].view(1, 128, 80, 64)
    Bo, Co = (xbc[..., k:k + 128].view(1, 128, 1, 128) for k in (5120, 5248))
    with pytest.raises(ValueError, match="16-byte units"):
        _route(xo, Bo, Co, y[:1], S[:1])
    # the FMA kernel reads element by element: any stride, any pointer
    assert _route(xo.float(), Bo.float(), Co.float(), y[:1], S[:1]) \
        == "fma_f32"
    with pytest.raises(TypeError, match="takes"):
        ssd_scan.kernel_for(torch.float16, "model", 128, 128, 64, [8] * 15,
                            [0] * 5)
    with pytest.raises(ValueError, match="q <= 128"):
        ssd_scan.kernel_for(torch.bfloat16, "model", 256, 128, 64,
                            [8] * 15, [0] * 5)
    with pytest.raises(ValueError, match="mode"):
        ssd_scan.kernel_for(torch.bfloat16, "tpu", 128, 128, 64, [8] * 15,
                            [0] * 5)


def _mamba2_ranges(T, q, R, rng):
    """dt and dA in Mamba-2's ranges (dt log-uniform in [1e-3, 1e-1] times
    a head's [0.5, 20], A in [-16, -1]), so that the decays reach the clip
    at exp(-60); as the card tests draw them."""
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (T, q, R))) \
        * rng.uniform(0.5, 20.0, (1, 1, R))
    A = -rng.uniform(1.0, 16.0, R)
    return dt.astype(np.float32), (dt * A).astype(np.float32)


def _split(v):
    """v (float32) as hi + lo, both bf16: the mma kernel's split of B * w."""
    hi = v.bfloat16()
    return hi, (v - hi.float()).bfloat16()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bw_split_into_two_bf16_is_exact(seed):
    """B * w, a product of two bf16 (w = rnd(decay_end * dt)), has at most
    16 significant bits, so hi = bf16(B * w) and lo = bf16(B * w - hi)
    hold it exactly; one bf16 would not.  Decays from 1 down to the clip
    at exp(-60), dt over Mamba-2's range, B over six decades."""
    rng = np.random.default_rng(seed)
    m = 1 << 14
    decay = np.exp(-np.concatenate([[60.0, 0.0], rng.uniform(0, 60, m - 2)]))
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), m)) \
        * rng.uniform(0.5, 20.0, m)
    w = torch.from_numpy((decay * dt).astype(np.float32)).bfloat16()
    B = torch.from_numpy((rng.standard_normal(m) * 10.0 ** rng.uniform(
        -3, 3, m)).astype(np.float32)).bfloat16()
    v = B.float() * w.float()
    assert torch.equal(v.double(), B.double() * w.double())  # exact product
    hi, lo = _split(v)
    assert torch.equal(lo.float(), v - hi.float())
    assert torch.equal(hi.float() + lo.float(), v)
    assert bool((hi.float() != v).any())


@pytest.mark.parametrize("T,q,G,r,p,n", [(2, 128, 1, 3, 64, 128),
                                         (3, 48, 2, 2, 16, 32)])
def test_model_state_through_the_bw_split(T, q, G, r, p, n):
    """S in ``model`` rounding summed as the mma kernel sums it, hi^T x +
    lo^T x into one float32 sum, equals ``ref.ssd_intra_plain``'s S
    within float32 sum-order error: |err| <= 4 q 2^-24 sum_j |B w| |x|
    (the plain q-term sum and the split's 2q-term sum, each within
    gamma_2q of that magnitude)."""
    rng = np.random.default_rng(3)
    R = G * r
    x = torch.from_numpy(rng.standard_normal((T, q, R, p), dtype=np.float32)
                         ).bfloat16()
    B, C = (torch.from_numpy(rng.standard_normal(
        (T, q, G, n), dtype=np.float32)).bfloat16() for _ in range(2))
    dt, dA = (torch.from_numpy(a) for a in _mamba2_ranges(T, q, R, rng))
    _, want = tref.ssd_intra_plain(x, dt, dA, B, C, mode="model")
    cs = torch.cumsum(dA, 1)
    w = (torch.exp(torch.clamp(cs[:, -1:] - cs, -60.0, 0.0)) * dt
         ).bfloat16().float()                                   # [T,q,R]
    assert float(w.min()) < 1e-20  # decays at the clip
    Bw = B.float().repeat_interleave(r, dim=2) * w[..., None]   # [T,q,R,n]
    hi, lo = _split(Bw)
    xf = x.float()
    got = torch.einsum("tqrn,tqrp->trnp", torch.cat([hi.float(), lo.float()],
                                                    1),
                       torch.cat([xf, xf], 1))
    bound = 4 * q * 2.0 ** -24 * torch.einsum("tqrn,tqrp->trnp", Bw.abs(),
                                              xf.abs())
    assert bool(((got - want).abs() <= bound).all())
    assert not torch.equal(hi.float(), Bw)  # the split mattered


# ---------------------------------------------------------------- the mixer


def cfgs(dtype="float32"):
    jc = dataclasses.replace(jget_smoke(ARCH), dtype=dtype)
    tc = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=dtype)
    return jc, tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches(dtype, with_state):
    b, s, g, r, p, n, chunk = 2, 32, 2, 2, 8, 16, 8
    rng = np.random.default_rng(2)
    jx, tx = both(rng.standard_normal((b, s, g, r, p), dtype=np.float32),
                  dtype)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, g, r)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal((g, r)) * 0.3).astype(np.float32)
    jB, tB = both(rng.standard_normal((b, s, g, n), dtype=np.float32), dtype)
    jC, tC = both(rng.standard_normal((b, s, g, n), dtype=np.float32), dtype)
    js0 = ts0 = None
    if with_state:
        js0, ts0 = both(rng.standard_normal((b, g, r, n, p),
                                            dtype=np.float32), dtype)
    jy, jf = JS.ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                            chunk, state0=js0)
    ty, tf = TS.ssd_chunked(tx, torch.from_numpy(dt), torch.from_numpy(A),
                            tB, tC, chunk, state0=ts0)
    assert ty.dtype == tf.dtype == TDT[dtype]
    assert_close(ty, jy, MODEL_TOL[dtype])
    assert_close(tf, jf, MODEL_TOL[dtype])


def mixer_params(jc, tc, seed=0):
    """The JAX mixer's init (with A_log and dt_bias drawn, so the decay
    varies per head) and the port's copy."""
    jp = JS.ssm_init(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    H = jc.ssm_heads
    jp["A_log"] = jnp.asarray(np.log(rng.uniform(1, 16, H)), jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.uniform(-4, 0, H), jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    leaves = {k: TM._tensor(v, TM._leaf_dtype((k,), tc), "cpu")
              for k, v in tree.items() if k != "norm"}
    norm = TL.RMSNorm(scale=torch.from_numpy(tree["norm"]["scale"].copy()))
    return jp, TS.Mixer(norm=norm, **leaves)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_apply_and_decode_step_match(dtype):
    """ssm_apply with a carried state and return_state, then one
    ssm_decode_step from a drawn cache."""
    jc, tc = cfgs(dtype)
    jp, tp = mixer_params(jc, tc)
    rng = np.random.default_rng(3)
    B_, S = 2, 24
    tol = MODEL_TOL[dtype]
    ju, tu = both(rng.standard_normal((B_, S, tc.d_model), dtype=np.float32),
                  dtype)
    G, r = tc.ssm_groups, tc.ssm_heads // tc.ssm_groups
    js, ts = both(rng.standard_normal((B_, G, r, tc.ssm_state,
                                       tc.ssm_headdim), dtype=np.float32),
                  dtype)
    out, fst = TS.ssm_apply(tp, tc, tu, state=ts, return_state=True)
    jout, jfst = JS.ssm_apply(jp, jc, ju, state=js, return_state=True)
    assert out.dtype == fst.dtype == TDT[dtype]
    assert_close(out, jout, tol)
    assert_close(fst, jfst, tol)

    conv_dim = tc.d_inner + 2 * G * tc.ssm_state
    jconv, tconv = both(rng.standard_normal(
        (B_, tc.ssm_conv - 1, conv_dim), dtype=np.float32), dtype)
    ju1, tu1 = both(rng.standard_normal((B_, 1, tc.d_model),
                                        dtype=np.float32), dtype)
    out, c = TS.ssm_decode_step(tp, tc, {"state": ts, "conv": tconv}, tu1)
    jout, jcache = JS.ssm_decode_step(jp, jc, {"state": js, "conv": jconv},
                                      ju1)
    assert_close(out, jout, tol)
    for k in ("state", "conv"):
        assert c[k].dtype == TDT[dtype]
        assert_close(c[k], jcache[k], tol)


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def jax_mamba2():
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc, tc = cfgs(dtype)
        m = jbuild(jc)
        out[dtype] = (jc, tc, m, m.init(jax.random.PRNGKey(0)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_smoke_serving_matches_jax(jax_mamba2, dtype):
    """forward, prefill and 4 greedy decode steps from init_cache (logits
    and caches) of mamba2-2.7b's smoke config."""
    jc, tc, jm, jparams = jax_mamba2[dtype]
    tparams = TM.params_from_jax(jax.tree.map(np.asarray, jparams), tc, "cpu")
    tm = TM.build(tc, "cpu")
    tol = MODEL_TOL[dtype]
    B, S = 2, 32
    toks = np.random.default_rng(7).integers(0, tc.vocab_size, (B, S)
                                             ).astype(np.int32)
    assert_close(tm.forward(tparams, {"tokens": torch.from_numpy(toks)}),
                 jm.forward(jparams, {"tokens": jnp.asarray(toks)},
                            remat=False), tol)
    jl, jc0 = jm.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc0 = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    assert jc0 is None and tc0 is None
    assert tl.shape == (B, 1, tc.padded_vocab) and tl.dtype == torch.float32
    assert_close(tl, jl, tol)

    jcache = jm.init_cache(B, S, JDT[dtype])
    tcache = tm.init_cache(B, S, TDT[dtype])
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for i in range(4):
        pos = np.full(B, S + i, np.int32)
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        assert_close(tl, jl, tol)
        for k in ("state", "conv"):
            assert tcache[k].dtype == TDT[dtype]
            assert_close(tcache[k], jcache[k], tol)
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_chunked_forward_equals_recurrent_decode():
    """float32, Mamba-2's init (numpy_params, so the decay of a chunk
    passes the clip): forward's logits at every position equal those of
    decode_step fed the same tokens one by one from init_cache."""
    _, tc = cfgs("float32")
    m = TM.build(tc, "cpu")
    params = TM.params_from_jax(TM.numpy_params(tc, 5), tc, "cpu")
    B, S = 2, 32
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tc.vocab_size, (B, S)).astype(np.int32))
    want = m.forward(params, {"tokens": toks})
    cache = m.init_cache(B, S, torch.float32)
    for i in range(S):
        lg, cache = m.decode_step(params, cache, toks[:, i:i + 1],
                                  torch.full((B,), i, dtype=torch.int32))
        assert_close(lg[:, 0], want[:, i], RECURRENT_TOL)


def test_params_round_trip(jax_mamba2):
    _, tc, _, jparams = jax_mamba2["bfloat16"]
    tree = jax.tree.map(np.asarray, jparams)
    back = TM.params_to_numpy(TM.params_from_jax(tree, tc, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert TM.param_shapes(tc) == {
        p: a.shape for p, a in TM._flatten(tree).items()}


def test_init_follows_the_reference_and_prefill_takes_no_cache():
    _, tc = cfgs()
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.build(tc)
    m = TM.build(tc, "cpu")
    params = m.init(torch.Generator().manual_seed(0))
    tree = TM.params_to_numpy(params)
    assert {p: a.shape for p, a in TM._flatten(tree).items()} == \
        TM.param_shapes(tc)
    mixer = tree["layers"]["mixer"]
    assert not mixer["A_log"].any() and not mixer["dt_bias"].any()
    assert (mixer["Dskip"] == 1).all() and not mixer["conv_b"].any()
    with pytest.raises(ValueError, match="no cache"):
        m.prefill(params, {"tokens": torch.zeros(1, 8, dtype=torch.int32)},
                  m.init_cache(1, 8))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        m.forward(params, {"tokens": torch.zeros(1, 12, dtype=torch.int32)})


def test_full_width_snapshot_on_the_cpu():
    """The port's plain path at mamba2-2.7b's full width (2 layers)
    against the JAX snapshot chip_smoke.py checks the card against: the
    digests of this checkout's numpy draws first, then the logits at the
    prefill's last position and 4 decode steps from init_cache (the
    snapshot's greedy tokens fed back), within SNAP_TOL."""
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
    logits, _ = m.prefill(params, {"tokens": torch.from_numpy(prompt)})
    cache = m.init_cache(B, S)
    for i, st in enumerate(snap["steps"]):
        if i:
            tok = torch.tensor(snap["steps"][i - 1]["token"],
                               dtype=torch.int32)[:, None]
            logits, cache = m.decode_step(
                params, cache, tok, torch.full((B,), S + i - 1,
                                               dtype=torch.int32))
        lg = logits[:, -1]
        got = torch.gather(lg, 1, torch.tensor(st["top_ids"])).numpy()
        np.testing.assert_allclose(got, st["top_logits"], atol=SNAP_TOL)
        np.testing.assert_allclose(torch.logsumexp(lg, -1).numpy(),
                                   st["logsumexp"], atol=SNAP_TOL)
        for b in range(B):
            if st["margin"][b] > SNAP_TOL:
                assert int(lg[b].argmax()) == st["token"][b]
