"""Shared building blocks; the port of ``repro.models.layers``.

Weights live in ``nn.Module``s (``Params`` subclasses) in the JAX
package's ``[in, out]`` orientation (``x @ w``), under the JAX dict's
key names, so that carrying a JAX pytree across is a copy, not a
transpose.  They are made without gradients, which is what serving
wants; ``trainable(params)`` turns every weight of a model trainable
(``train.train_step.init_state`` calls it), after which the forward
builds the autograd graph and ``remat`` recomputes a layer in the
backward pass.  Each block also has the JAX package's functional form
(``rms_norm(p, x, eps)``, ``attn_apply(p, cfg, ...)``, ...), which the
tests hold against the reference one by one.

Matrix products go through ``torch.matmul`` and accumulate in float32
(cuBLAS does for bf16; on the CPU bf16 operands are widened first, as
the reference does there).  Prefill attention calls
``ops.flash_attention`` and decode attention ``ops.paged_attention``:
the hand-written CUDA kernels on the card, their plain versions on the
CPU.  Both take the attention options of the reference's layers:
qk_norm, sliding windows (prefill through the flash kernel's window
mask, decode through a ring cache), M-RoPE and cross-attention.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


class Params(nn.Module):
    """Named weight tensors, registered as parameters without gradients
    (``trainable`` turns them on)."""

    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


def trainable(params: nn.Module) -> nn.Module:
    """Every weight of ``params`` set to require gradients, in place;
    returns ``params``."""
    return params.requires_grad_(True)


def remat(fn, on: bool, *args):
    """``fn(*args)``; under autograd with ``on``, through
    ``torch.utils.checkpoint`` (non-reentrant): only the inputs are kept,
    and the backward pass runs ``fn`` again, as the reference's
    ``jax.checkpoint(..., nothing_saveable)``."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


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


def mrope_cos_sin(positions3, head_dim: int, theta: float, sections):
    """``rope_cos_sin`` for multimodal RoPE (qwen2-vl): positions3 [3,B,S]
    are the (t, h, w) position streams, and ``sections`` split the hd/2
    rotary dims among them in that order.  Returns [B,S,1,hd/2]."""
    freqs = rope_freqs(head_dim, theta, positions3.device)   # [hd/2]
    idx = torch.arange(head_dim // 2, device=positions3.device)
    which = ((idx >= sections[0]).long()
             + (idx >= sections[0] + sections[1]).long())   # [hd/2] in {0,1,2}
    pos = positions3.float()[which]                          # [hd/2,B,S]
    ang = (pos.permute(1, 2, 0) * freqs)[..., None, :]       # [B,S,1,hd/2]
    return torch.cos(ang), torch.sin(ang)


def apply_mrope(x, positions3, theta: float, sections, cos_sin=None):
    """x [B,S,H,hd]; positions3 [3,B,S].  ``cos_sin``:
    ``mrope_cos_sin(positions3, hd, theta, sections)``."""
    if cos_sin is None:
        cos_sin = mrope_cos_sin(positions3, x.shape[-1], theta, sections)
    return apply_rope(x, None, theta, cos_sin)


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
    """wq [D, H*hd], wk/wv [D, K*hd], wo [H*hd, D]; with qk_norm also
    q_norm and k_norm (RMSNorms over hd)."""

    def __init__(self, q_norm=None, k_norm=None, **tensors):
        super().__init__(**tensors)
        if q_norm is not None:
            self.q_norm, self.k_norm = q_norm, k_norm


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> Attention:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg)
    norms = {}
    if cfg.qk_norm:
        norms = {"q_norm": rms_norm_init(hd, gen.device),
                 "k_norm": rms_norm_init(hd, gen.device)}
    return Attention(wq=dense_init(gen, (D, H * hd), dtype=dt),
                     wk=dense_init(gen, (D, K * hd), dtype=dt),
                     wv=dense_init(gen, (D, K * hd), dtype=dt),
                     wo=dense_init(gen, (H * hd, D), dtype=dt), **norms)


def positional_cos_sin(cfg: ModelConfig, positions, positions3=None):
    """The rotary cos and sin a forward or decode step shares across its
    layers: M-RoPE's from ``positions3`` where the config has sections and
    the caller gives them, plain RoPE's from ``positions`` elsewhere (as
    the reference's ``attn_apply`` chooses)."""
    if positions3 is not None and cfg.mrope_sections:
        return mrope_cos_sin(positions3, cfg.hd, cfg.rope_theta,
                             cfg.mrope_sections)
    return rope_cos_sin(positions, cfg.hd, cfg.rope_theta)


def _qk_norm(p, cfg: ModelConfig, q, k):
    """qk_norm's RMSNorms of q and k over hd (before any rotation)."""
    if cfg.qk_norm:
        q = rms_norm(p.q_norm, q, cfg.norm_eps)
        k = rms_norm(p.k_norm, k, cfg.norm_eps)
    return q, k


def _rotate(cfg: ModelConfig, q, k, positions, positions3, cos_sin):
    """RoPE or M-RoPE of q and k (``positional_cos_sin``)."""
    if cos_sin is None:
        cos_sin = positional_cos_sin(cfg, positions, positions3)
    return (apply_rope(q, None, cfg.rope_theta, cos_sin),
            apply_rope(k, None, cfg.rope_theta, cos_sin))


def attn_apply(p, cfg: ModelConfig, x, positions, *, causal=True,
               window=None, kv=None, positions3=None, cos_sin=None):
    """Full-sequence attention (prefill): x [B,S,D], positions [B,S] =
    0..S-1 in every row (the flash kernel's masks read a position as its
    index).  ``cos_sin``: ``positional_cos_sin`` of these positions, if
    the caller has it.  Returns (out, (k, v)) with k, v [B,Sk,K,hd] for
    the cache.

    With ``kv`` [B,Sk,D] (an encoder's output) it is cross-attention: k
    and v are projected from ``kv``, nothing is rotated and nothing
    masked, as in the reference (whose ``kv_positions`` then reach no
    mask and no rotation, so the port takes none).  ``window`` limits
    each query to the ``window`` latest keys; ``positions3`` [3,B,S]
    selects M-RoPE.

    The attention itself is ``ops.flash_attention`` at every size; the
    reference's switch between two forms of the same function
    (``ATTN_CHUNK_THRESHOLD``) only chose how much memory XLA used."""
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    src = x if kv is None else kv
    Sk = src.shape[1]
    q = matmul(x, p.wq).reshape(B, S, H, hd)
    k = matmul(src, p.wk).reshape(B, Sk, K, hd)
    v = matmul(src, p.wv).reshape(B, Sk, K, hd)
    q, k = _qk_norm(p, cfg, q, k)
    if kv is None:
        q, k = _rotate(cfg, q, k, positions, positions3, cos_sin)
    out = ops.flash_attention(q, k, v, causal=causal and kv is None,
                              window=window)
    return matmul(out.reshape(B, S, H * hd), p.wo), (k, v)


def attn_decode(p, cfg: ModelConfig, x, pos, k_cache, v_cache, *,
                page: int, window=None, positions3=None, cos_sin=None):
    """Single-token decode against one layer's KV cache.

    x [B,1,D]; pos [B] current positions; caches [B,S,K,hd] with
    S % page == 0.  Writes the new K/V at slot ``pos`` (``pos % S`` with
    a ``window``: the ring) IN PLACE, then attends over the cache viewed
    as pages ``[B*S/page, page, K, hd]`` with the identity table
    ``tables[b, i] = b*nb + i`` and ``lens = min(pos + 1, S)``.  That is
    the reference's mask: without a window it keeps ``kpos <= pos``; in
    a ring of S <= window slots it keeps exactly slots 0..min(pos, S-1),
    and softmax does not depend on the keys' order.  ``positions3``
    [3,B,1] selects M-RoPE.  Returns (out, k_cache, v_cache)."""
    B, _, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    S = k_cache.shape[1]
    _pages(S, page)
    if window is not None and S > window:
        raise ValueError(f"a ring cache holds at most window = {window} "
                         f"slots, this one {S} (init_cache sizes it)")
    q = matmul(x, p.wq).reshape(B, 1, H, hd)
    k = matmul(x, p.wk).reshape(B, 1, K, hd)
    v = matmul(x, p.wv).reshape(B, 1, K, hd)
    q, k = _qk_norm(p, cfg, q, k)
    q, k = _rotate(cfg, q, k, pos[:, None], positions3, cos_sin)
    bidx = torch.arange(B, device=x.device)
    slot = pos.long() if window is None else pos.long() % S
    k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)
    lens = torch.clamp(pos + 1, max=S).to(torch.int32)
    out = paged_identity(q.reshape(B, H, hd), k_cache, v_cache, lens, page)
    return matmul(out.reshape(B, 1, H * hd), p.wo), k_cache, v_cache


def _pages(S: int, page: int) -> int:
    """Pages of a cache of S positions; raises unless page divides S."""
    if S % page:
        raise ValueError(f"cache length {S} is not a multiple of the page "
                         f"size {page}")
    return S // page


def paged_identity(q, k_cache, v_cache, lens, page: int):
    """``ops.paged_attention`` of q [B,H,hd] over caches [B,S,K,hd] viewed
    as pages [B*S/page, page, K, hd] through the identity table
    ``tables[b, i] = b*nb + i``, the first ``lens[b]`` positions of row
    b."""
    B, S, K, hd = k_cache.shape
    nb = _pages(S, page)
    tables = torch.arange(B * nb, dtype=torch.int32,
                          device=q.device).reshape(B, nb)
    return ops.paged_attention(q, k_cache.view(B * nb, page, K, hd),
                               v_cache.view(B * nb, page, K, hd), tables,
                               lens)


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
    gate = F.silu(matmul(x, p.wg).float()).to(x.dtype)
    return matmul(gate * matmul(x, p.wi), p.wo)


class MoE(Params):
    """The experts' FFN (``models.moe``): router [D, E] (float32), wi/wg
    [E, D, F], wo [E, F, D]."""


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


def embed_apply(p, tokens, input_embeds=None):
    """Token embeddings [B,S,D]; ``input_embeds`` [B,P,D] (the vlm and
    audio stubs) replace the first P rows, as the reference's.
    ``F.embedding``: its backward on the card sums a repeated token's rows
    in a fixed order, where indexing's adds them with atomics."""
    x = F.embedding(tokens.long(), p.tok)
    if input_embeds is not None:
        P = input_embeds.shape[1]
        x = torch.cat([input_embeds.to(x.dtype), x[:, P:]], dim=1)
    return x


def logits_apply(p, x):
    """Logits in float32 (the reference's ``preferred_element_type``): the
    product is taken in float32, since a bf16 product would round them."""
    w = p.head if hasattr(p, "head") else p.tok.T
    return torch.matmul(x.float(), w.float())
