"""Shared building blocks; the port of ``repro.models.layers`` for the
dense and ssm families.

Weights live in ``nn.Module``s (``Params`` subclasses) in the JAX
package's ``[in, out]`` orientation (``x @ w``), under the JAX dict's
key names, so that carrying a JAX pytree across is a copy, not a
transpose.  They hold no gradients: the port serves, it does not train
yet.  Each block also has the JAX package's functional form
(``rms_norm(p, x, eps)``, ``attn_apply(p, cfg, ...)``, ...), which the
tests hold against the reference one by one.

Matrix products go through ``torch.matmul`` and accumulate in float32
(cuBLAS does for bf16; on the CPU bf16 operands are widened first, as
the reference does there).  Prefill attention calls
``ops.flash_attention`` and decode attention ``ops.paged_attention``:
the hand-written CUDA kernels on the card, their plain versions on the
CPU.  Windows, qk_norm and M-RoPE are not ported yet; a configuration
that asks for one raises.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


FAMILIES = ("dense", "ssm")  # the model families the port runs


def check_ported(cfg: ModelConfig):
    """Raise on the families and attention options the port does not run
    yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP Queue 1, Models)")
    for what, on in (("qk_norm", cfg.qk_norm),
                     ("window", cfg.window is not None),
                     ("mrope_sections", cfg.mrope_sections is not None)):
        if on:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet (ROADMAP Queue 1, "
                f"Models)")


class Params(nn.Module):
    """Named weight tensors, registered as parameters without gradients."""

    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


def dense_init(gen: torch.Generator, shape, in_axis=0, dtype=torch.float32):
    """Normal(0, 1/fan_in) draws from ``gen``, on ``gen``'s device."""
    fan_in = shape[in_axis]
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * (1.0 / fan_in ** 0.5)).to(dtype)


def matmul(x, w):
    """x @ w with float32 accumulation, cast back to x's dtype."""
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        return torch.matmul(x.float(), w.float()).to(x.dtype)
    return torch.matmul(x, w).to(x.dtype)


# ---------------------------------------------------------------- norms


class RMSNorm(Params):
    """scale [d] (float32)."""


def rms_norm_init(d: int, device=None) -> RMSNorm:
    return RMSNorm(scale=torch.ones(d, dtype=torch.float32, device=device))


def rms_norm(p, x, eps: float):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p.scale
    return y.to(x.dtype)


# ---------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float, device=None):
    # a Python base: a tensor made from it on the card would be a
    # synchronising host-to-device copy on every call
    return torch.pow(theta, -torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=device) / head_dim)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """cos and sin of the rotary angles, [..., S, 1, hd/2] float32: what
    ``apply_rope`` needs for these positions.  The model makes them once
    per forward or decode step and shares them between q and k and
    across layers (eight launches fewer per call of apply_rope)."""
    freqs = rope_freqs(head_dim, theta, positions.device)    # [hd/2]
    ang = positions[..., None].float() * freqs               # [..., S, hd/2]
    ang = ang[..., None, :]                                  # [..., S, 1, hd/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float, cos_sin=None):
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable).
    ``cos_sin``: ``rope_cos_sin(positions, hd, theta)``.  Every model
    caller passes it; the default, which makes it here, exists only for
    the reference-shaped signatures the port's tests call (as do the
    same defaults on ``attn_apply`` and ``attn_decode``)."""
    if cos_sin is None:
        cos_sin = rope_cos_sin(positions, x.shape[-1], theta)
    cos, sin = cos_sin
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention


class Attention(Params):
    """wq [D, H*hd], wk/wv [D, K*hd], wo [H*hd, D]."""


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> Attention:
    check_ported(cfg)
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg)
    return Attention(wq=dense_init(gen, (D, H * hd), dtype=dt),
                     wk=dense_init(gen, (D, K * hd), dtype=dt),
                     wv=dense_init(gen, (D, K * hd), dtype=dt),
                     wo=dense_init(gen, (H * hd, D), dtype=dt))


def attn_apply(p, cfg: ModelConfig, x, positions, *, causal=True,
               cos_sin=None):
    """Full-sequence self-attention (prefill): x [B,S,D], positions
    [B,S] (``cos_sin``: their ``rope_cos_sin``, if the caller has it).
    Returns (out, (k, v)) with k, v [B,S,K,hd] for the cache.

    The attention itself is ``ops.flash_attention`` at every size; the
    reference's switch between two forms of the same function
    (``ATTN_CHUNK_THRESHOLD``) only chose how much memory XLA used."""
    check_ported(cfg)
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = matmul(x, p.wq).reshape(B, S, H, hd)
    k = matmul(x, p.wk).reshape(B, S, K, hd)
    v = matmul(x, p.wv).reshape(B, S, K, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cos_sin)
    k = apply_rope(k, positions, cfg.rope_theta, cos_sin)
    out = ops.flash_attention(q, k, v, causal=causal)
    return matmul(out.reshape(B, S, H * hd), p.wo), (k, v)


def attn_decode(p, cfg: ModelConfig, x, pos, k_cache, v_cache, *,
                page: int, cos_sin=None):
    """Single-token decode against one layer's KV cache.

    x [B,1,D]; pos [B] current positions; caches [B,S,K,hd] with
    S % page == 0.  Writes the new K/V at ``pos`` IN PLACE, then attends
    over the cache viewed as pages ``[B*S/page, page, K, hd]`` with the
    identity table ``tables[b, i] = b*nb + i`` and ``lens = pos + 1``
    (the reference's mask ``kpos <= pos``).  Returns (out, k_cache,
    v_cache)."""
    check_ported(cfg)
    B, _, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    S = k_cache.shape[1]
    if S % page:
        raise ValueError(f"cache length {S} is not a multiple of the page "
                         f"size {page}")
    q = matmul(x, p.wq).reshape(B, 1, H, hd)
    k = matmul(x, p.wk).reshape(B, 1, K, hd)
    v = matmul(x, p.wv).reshape(B, 1, K, hd)
    q = apply_rope(q, pos[:, None], cfg.rope_theta, cos_sin)
    k = apply_rope(k, pos[:, None], cfg.rope_theta, cos_sin)
    bidx = torch.arange(B, device=x.device)
    pos_l = pos.long()
    k_cache[bidx, pos_l] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, pos_l] = v[:, 0].to(v_cache.dtype)
    nb = S // page
    tables = torch.arange(B * nb, dtype=torch.int32,
                          device=x.device).reshape(B, nb)
    lens = (pos + 1).to(torch.int32)
    out = ops.paged_attention(q.reshape(B, H, hd),
                              k_cache.view(B * nb, page, K, hd),
                              v_cache.view(B * nb, page, K, hd),
                              tables, lens)
    return matmul(out.reshape(B, 1, H * hd), p.wo), k_cache, v_cache


# ---------------------------------------------------------------- MLP


class MLP(Params):
    """SwiGLU: wi, wg [D, F], wo [F, D]."""


def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff=None) -> MLP:
    D, F = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    return MLP(wi=dense_init(gen, (D, F), dtype=dt),
               wg=dense_init(gen, (D, F), dtype=dt),
               wo=dense_init(gen, (F, D), dtype=dt))


def mlp_apply(p, x):
    gate = torch.nn.functional.silu(matmul(x, p.wg).float()).to(x.dtype)
    return matmul(gate * matmul(x, p.wi), p.wo)


# ---------------------------------------------------------------- embeddings


class Embed(Params):
    """tok [V, D]; head [D, V] unless the embeddings are tied."""


def embed_init(gen: torch.Generator, cfg: ModelConfig) -> Embed:
    V, D = cfg.padded_vocab, cfg.d_model
    dt = dtype_of(cfg)
    w = {"tok": dense_init(gen, (V, D), dtype=dt)}
    if not cfg.tie_embeddings:
        w["head"] = dense_init(gen, (D, V), dtype=dt)
    return Embed(**w)


def embed_apply(p, tokens):
    return p.tok[tokens.long()]


def logits_apply(p, x):
    """Logits in float32 (the reference's ``preferred_element_type``): the
    product is taken in float32, since a bf16 product would round them."""
    w = p.head if hasattr(p, "head") else p.tok.T
    return torch.matmul(x.float(), w.float())
