"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427); the port of
``repro.models.rglru``.

The repeating unit is (rec, rec, attn): two RG-LRU recurrent blocks and
one local-attention block (window ``local_window``, MQA).  26 layers are
8 such superblocks and a tail of 2 recurrent blocks.  The attention
block runs ``layers.attn_apply`` with the window, so its prefill is the
flash kernel (hd 256 at full width) and its decode the paged kernel over
a ring of ``min(local_window, seq_len)`` slots (``layers.attn_decode``).

The RG-LRU's linear recurrence h_t = a_t h_{t-1} + u_t is associative;
the reference runs it as ``lax.associative_scan``, outside any Pallas
kernel, and here it is a log-step scan in plain PyTorch
(``linear_scan``: ceil(log2 S) rounds of a few element-wise ops over
[B, S, W], not a loop over positions).  Its float32 sums run in another
order than XLA's tree, so the two agree within float32 rounding, not
bit for bit.

What the reference's dtypes say, kept here:
- the gates' block-diagonal products (16 blocks) come out in float32,
  and the recurrence runs in float32; the prefill's last state
  ``h_last`` stays float32, while ``rglru_step`` rounds the new state to
  the input's dtype (the decode cache carries h in bf16);
- ``_conv4`` sums its 4 taps in the input's dtype in Python's ``sum``
  order, plus ``conv_b`` cast to that dtype; the decode step sums the
  history with ``torch.sum`` (the reference's ``jnp.sum``), a different
  expression, and each path follows its own;
- the gate is ``jax.nn.gelu``, whose default is the tanh approximation,
  so here ``F.gelu(..., approximate="tanh")``.

Weights live in ``nn.Module``s under the JAX dict's keys: ``Hybrid``
holds ``embed``, ``super`` (a ``ModuleList`` of ``Super`` blocks, each
``rec1``, ``rec2`` and ``attn``), ``tail`` (recurrent blocks) and
``ln_f``.  The decode cache keeps the reference's layout: ``h1 c1 h2 c2``
[n_super, B, W] and [n_super, B, 3, W], ``k v`` [n_super, B, Wnd, K,
hd], and for the tail ``th tc``; ``decode_step`` updates it in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import TOKENS_PER_PAGE

N_GATE_BLOCKS = 16
LRU_C = 8.0


class RGLRU(L.Params):
    """wa, wx [16, W/16, W/16] (the config's dtype); ba, bx, a_param [W]
    (float32)."""


class RecBlock(L.Params):
    """ln1, wxin and wgate [D, W], conv_w [4, W], conv_b [W] (float32),
    lru, wout [W, D], ln2, mlp."""

    def __init__(self, ln1, lru, ln2, mlp, **tensors):
        super().__init__(**tensors)
        self.ln1, self.lru, self.ln2, self.mlp = ln1, lru, ln2, mlp


class AttnBlock(nn.Module):
    def __init__(self, ln1, attn, ln2, mlp):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class Super(nn.Module):
    """One repeating unit: rec1, rec2, attn."""

    def __init__(self, rec1, rec2, attn):
        super().__init__()
        self.rec1, self.rec2, self.attn = rec1, rec2, attn


class Hybrid(nn.Module):
    """The parameters of a hybrid model: embed, super, tail, ln_f."""

    def __init__(self, embed, super_, tail, ln_f):
        super().__init__()
        self.embed = embed
        self.super = nn.ModuleList(super_)
        self.tail = nn.ModuleList(tail)
        self.ln_f = ln_f


def lru_width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def layout(cfg: ModelConfig):
    """(superblocks, tail blocks): 26 layers of (rec, rec, attn) are 8
    and 2."""
    P = len(cfg.block_pattern)
    n_super = cfg.n_layers // P
    return n_super, cfg.n_layers - n_super * P


# ---------------------------------------------------------------- RG-LRU


def rglru_init(gen: torch.Generator, cfg: ModelConfig) -> RGLRU:
    """The reference's init: block-diagonal gates normal(0, 1/(W/16)),
    zero biases, and a_param such that a = exp(-8 softplus(a_param)) is
    uniform in (0.9, 0.999) at r = 1 (the paper's init)."""
    W, nb, dev = lru_width(cfg), N_GATE_BLOCKS, gen.device

    def bdiag():
        w = torch.randn((nb, W // nb, W // nb), generator=gen,
                        dtype=torch.float32, device=dev)
        return (w / math.sqrt(W // nb)).to(L.dtype_of(cfg))

    wa, wx = bdiag(), bdiag()
    lam = torch.rand(W, generator=gen, dtype=torch.float32, device=dev) \
        * (0.999 - 0.9) + 0.9
    zeros = torch.zeros(W, dtype=torch.float32, device=dev)
    return RGLRU(wa=wa, ba=zeros, wx=wx, bx=zeros.clone(),
                 a_param=torch.log(torch.expm1(-torch.log(lam) / LRU_C)))


def bdiag_apply(wt, x):
    """x [B,S,W] through 16 diagonal blocks wt [16, W/16, W/16]; float32
    out (the products of bf16 operands are exact in float32, and the
    sums accumulate there, as ``einsum_f32`` does)."""
    nb = wt.shape[0]
    B, S, W = x.shape
    xb = x.reshape(B * S, nb, W // nb).float().transpose(0, 1)
    y = torch.bmm(xb, wt.float())                   # [nb, B*S, W/nb]
    return y.transpose(0, 1).reshape(B, S, W)


def linear_scan(a, u):
    """h_t = a_t h_{t-1} + u_t along axis 1 from h_{-1} = 0: a log-step
    (Hillis-Steele) scan of ``combine((a1, u1), (a2, u2)) = (a1 a2, u1 a2
    + u2)``, ceil(log2 S) rounds.  a, u [B,S,W] float32."""
    S, d = u.shape[1], 1
    while d < S:
        u = torch.cat([u[:, :d], torch.addcmul(u[:, d:], a[:, d:],
                                               u[:, :-d])], 1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return u


def _gates(p, x):
    """r, i and log a, float32, for x [B,S,W]."""
    r = torch.sigmoid(bdiag_apply(p.wa, x) + p.ba)
    i = torch.sigmoid(bdiag_apply(p.wx, x) + p.bx)
    log_a = -LRU_C * F.softplus(p.a_param) * r
    return i, log_a


def _gated(i, log_a, x):
    """sqrt(1 - a^2) i x, the clamp at 1e-12 the reference's."""
    return torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * i * x.float()


def rglru_apply(p, x, h0=None):
    """x [B,S,W] -> (y [B,S,W] in x's dtype, h_last [B,W] float32)."""
    i, log_a = _gates(p, x)
    a = torch.exp(log_a)
    gated = _gated(i, log_a, x)
    if h0 is not None:
        gated[:, 0] += a[:, 0] * h0.float()
    h = linear_scan(a, gated)
    return h.to(x.dtype), h[:, -1]


def rglru_step(p, x_t, h):
    """One decode step: x_t [B,W], h [B,W].  Returns (y, h'), both the
    new state rounded to x_t's dtype, as the reference returns them."""
    i, log_a = _gates(p, x_t[:, None])
    i, log_a = i[:, 0], log_a[:, 0]
    h2 = torch.exp(log_a) * h.float() + _gated(i, log_a, x_t)
    h2 = h2.to(x_t.dtype)
    return h2, h2


# ---------------------------------------------------------------- blocks


def rec_block_init(gen: torch.Generator, cfg: ModelConfig) -> RecBlock:
    W, D, dev = lru_width(cfg), cfg.d_model, gen.device
    dt = L.dtype_of(cfg)
    conv_w = torch.randn((4, W), generator=gen, dtype=torch.float32,
                         device=dev) * 0.1
    return RecBlock(ln1=L.rms_norm_init(D, dev),
                    wxin=L.dense_init(gen, (D, W), dtype=dt),
                    wgate=L.dense_init(gen, (D, W), dtype=dt),
                    conv_w=conv_w.to(dt),
                    conv_b=torch.zeros(W, dtype=torch.float32, device=dev),
                    lru=rglru_init(gen, cfg),
                    wout=L.dense_init(gen, (W, D), dtype=dt),
                    ln2=L.rms_norm_init(D, dev), mlp=L.mlp_init(gen, cfg))


def conv4(x, w, b):
    """The 4-tap causal convolution: ``sum`` of the shifted products in
    x's dtype (Python's order, from 0), plus b in x's dtype."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + S] * w[i] for i in range(K)) + b.to(x.dtype)


def _gelu(x, dtype):
    """jax.nn.gelu's default (tanh) form in float32, cast to dtype."""
    return F.gelu(x.float(), approximate="tanh").to(dtype)


def rec_block_apply(lp: RecBlock, cfg: ModelConfig, x, h0=None, conv0=None,
                    return_state=False):
    """A recurrent block over x [B,S,D].  ``h0`` [B,W] and ``conv0``
    [B,3,W] continue a sequence; ``return_state`` also returns (h_last
    float32, the last 3 conv inputs)."""
    h = L.rms_norm(lp.ln1, x, cfg.norm_eps)
    xin = L.matmul(h, lp.wxin)
    gate = _gelu(L.matmul(h, lp.wgate), x.dtype)
    if conv0 is not None:   # stitch the conv history
        full = torch.cat([conv0.to(xin.dtype), xin], 1)
        conv_out = conv4(full, lp.conv_w, lp.conv_b)[:, conv0.shape[1]:]
        new_conv = full[:, -3:]
    else:
        conv_out = conv4(xin, lp.conv_w, lp.conv_b)
        new_conv = xin[:, -3:]
    y, h_last = rglru_apply(lp.lru, conv_out, h0=h0)
    x = x + L.matmul(y * gate, lp.wout)
    x = x + L.mlp_apply(lp.mlp, L.rms_norm(lp.ln2, x, cfg.norm_eps))
    if return_state:
        return x, (h_last, new_conv)
    return x


def attn_block_init(gen: torch.Generator, cfg: ModelConfig) -> AttnBlock:
    dev = gen.device
    return AttnBlock(ln1=L.rms_norm_init(cfg.d_model, dev),
                     attn=L.attn_init(gen, cfg),
                     ln2=L.rms_norm_init(cfg.d_model, dev),
                     mlp=L.mlp_init(gen, cfg))


def attn_block_apply(lp: AttnBlock, cfg: ModelConfig, x, positions,
                     cos_sin=None, return_kv=False):
    """Local attention (``cfg.local_window``) and the MLP over x [B,S,D]."""
    h = L.rms_norm(lp.ln1, x, cfg.norm_eps)
    a, kv = L.attn_apply(lp.attn, cfg, h, positions,
                         window=cfg.local_window, cos_sin=cos_sin)
    x = x + a
    x = x + L.mlp_apply(lp.mlp, L.rms_norm(lp.ln2, x, cfg.norm_eps))
    if return_kv:
        return x, kv
    return x


# ------------------------------------------------------------ full model


def init(gen: torch.Generator, cfg: ModelConfig) -> Hybrid:
    """Random parameters drawn from ``gen``, on its device."""
    n_super, tail = layout(cfg)
    embed = L.embed_init(gen, cfg)
    supers = [Super(rec1=rec_block_init(gen, cfg),
                    rec2=rec_block_init(gen, cfg),
                    attn=attn_block_init(gen, cfg)) for _ in range(n_super)]
    return Hybrid(embed=embed, super_=supers,
                  tail=[rec_block_init(gen, cfg) for _ in range(tail)],
                  ln_f=L.rms_norm_init(cfg.d_model, gen.device))


def _hidden(params: Hybrid, cfg: ModelConfig, tokens):
    """The residual stream after the last block, [B,S,D]."""
    B, S = tokens.shape
    x = L.embed_apply(params.embed, tokens)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    cos_sin = L.positional_cos_sin(cfg, positions)
    for sp in params.super:
        x = rec_block_apply(sp.rec1, cfg, x)
        x = rec_block_apply(sp.rec2, cfg, x)
        x = attn_block_apply(sp.attn, cfg, x, positions, cos_sin)
    for lp in params.tail:
        x = rec_block_apply(lp, cfg, x)
    return x


@torch.no_grad()
def forward(params: Hybrid, cfg: ModelConfig, tokens):
    """tokens [B,S] -> logits [B,S,V] (float32)."""
    x = L.rms_norm(params.ln_f, _hidden(params, cfg, tokens), cfg.norm_eps)
    return L.logits_apply(params.embed, x)


@torch.no_grad()
def prefill(params: Hybrid, cfg: ModelConfig, tokens):
    """The logits of the last position [B,1,V] and no cache, as the
    reference's prefill for the hybrid family returns
    (``model.py:111-114``): its decode starts from ``init_cache``.  Only
    the last position's logits are computed; they equal ``forward``'s."""
    x = _hidden(params, cfg, tokens)[:, -1:]
    x = L.rms_norm(params.ln_f, x, cfg.norm_eps)
    return L.logits_apply(params.embed, x), None


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None):
    """Zero states: h [n, B, W], the conv history [n, B, 3, W] and a ring
    of Wnd = min(local_window, seq_len) K/V slots [n, B, Wnd, K, hd] per
    superblock, and ``th tc`` for the tail."""
    n_super, tail = layout(cfg)
    W, wnd = lru_width(cfg), min(cfg.local_window, seq_len)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    c = {"h1": z(n_super, batch, W), "c1": z(n_super, batch, 3, W),
         "h2": z(n_super, batch, W), "c2": z(n_super, batch, 3, W),
         "k": z(n_super, batch, wnd, cfg.n_kv_heads, cfg.hd),
         "v": z(n_super, batch, wnd, cfg.n_kv_heads, cfg.hd)}
    if tail:
        c["th"], c["tc"] = z(tail, batch, W), z(tail, batch, 3, W)
    return c


def _rec_step(lp: RecBlock, cfg: ModelConfig, x, h, conv):
    """One token through a recurrent block: x [B,1,D], h [B,W], conv
    [B,3,W].  Returns (x, h', conv')."""
    hh = L.rms_norm(lp.ln1, x, cfg.norm_eps)
    xin = L.matmul(hh, lp.wxin)[:, 0]
    gate = _gelu(L.matmul(hh, lp.wgate), x.dtype)[:, 0]
    hist = torch.cat([conv.to(xin.dtype), xin[:, None]], 1)   # [B,4,W]
    cv = torch.sum(hist * lp.conv_w[None], dim=1) + lp.conv_b.to(x.dtype)
    y, h2 = rglru_step(lp.lru, cv, h)
    x = x + L.matmul((y * gate)[:, None], lp.wout)
    x = x + L.mlp_apply(lp.mlp, L.rms_norm(lp.ln2, x, cfg.norm_eps))
    return x, h2, hist[:, 1:]


@torch.no_grad()
def decode_step(params: Hybrid, cfg: ModelConfig, cache, tokens, pos, *,
                page: int = TOKENS_PER_PAGE):
    """One decode step.  tokens [B,1]; pos [B].  Returns (logits [B,1,V]
    float32, cache), the cache updated in place: each superblock's
    states and conv histories, and its ring at ``pos % Wnd`` (the paged
    kernel over the ring, ``layers.attn_decode`` with the window; Wnd
    must be a multiple of ``page``)."""
    x = L.embed_apply(params.embed, tokens)
    cos_sin = L.positional_cos_sin(cfg, pos[:, None])
    for i, sp in enumerate(params.super):
        for r, (hk, ck) in ((sp.rec1, ("h1", "c1")),
                            (sp.rec2, ("h2", "c2"))):
            x, cache[hk][i], cache[ck][i] = _rec_step(
                r, cfg, x, cache[hk][i], cache[ck][i])
        hh = L.rms_norm(sp.attn.ln1, x, cfg.norm_eps)
        a, _, _ = L.attn_decode(sp.attn.attn, cfg, hh, pos, cache["k"][i],
                                cache["v"][i], page=page,
                                window=cfg.local_window, cos_sin=cos_sin)
        x = x + a
        x = x + L.mlp_apply(sp.attn.mlp,
                            L.rms_norm(sp.attn.ln2, x, cfg.norm_eps))
    for i, lp in enumerate(params.tail):
        x, cache["th"][i], cache["tc"][i] = _rec_step(
            lp, cfg, x, cache["th"][i], cache["tc"][i])
    x = L.rms_norm(params.ln_f, x, cfg.norm_eps)
    return L.logits_apply(params.embed, x), cache
