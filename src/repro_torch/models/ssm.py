"""Mamba2 (state-space duality / SSD, arXiv:2405.21060); the port of
``repro.models.ssm``.

The chunked SSD forward keeps the reference's dtypes step by step.  Its
intra-chunk block (the reference's einsums at ``ssm.py:65-84``) is
``kernels.ssd_scan.ssd_intra`` in ``model`` rounding: the hand-written
CUDA kernel on the card, its plain version on the CPU.  It reads x, B and
C where the convolution left them (x is a strided slice of ``xBC``, B and
C stay per group), so nothing is expanded to the heads.  The
inter-chunk recurrence, which the reference runs as an
``associative_scan``, is the same recurrence as a float32 loop over the
chunks.

Weights live in ``nn.Module``s under the JAX dict's keys (``ln``,
``mixer/{in_proj, conv_w, conv_b, dt_bias, A_log, Dskip, norm/scale,
out_proj}``), layers in a ``ModuleList`` run by a Python loop.  The
decode cache keeps the reference's layout, ``{"state":
[L,B,G,r,N,P], "conv": [L,B,K-1,conv_dim]}``; ``decode_step`` writes it
in place (in the cache's dtype) and returns it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ssd_scan
from repro_torch.models import layers as L


class Mixer(L.Params):
    """in_proj [D, 2di+2GN+H], conv_w [K, conv_dim], conv_b [conv_dim],
    dt_bias, A_log, Dskip [H] (float32), norm (over di), out_proj [di, D]."""

    def __init__(self, norm: L.RMSNorm, **tensors):
        super().__init__(**tensors)
        self.norm = norm


class Block(nn.Module):
    def __init__(self, ln, mixer):
        super().__init__()
        self.ln, self.mixer = ln, mixer


class SSM(nn.Module):
    """The parameters of a mamba2 model: embed, layers, ln_f."""

    def __init__(self, embed, layers, ln_f):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.ln_f = ln_f


def _dims(cfg: ModelConfig):
    """(d_inner, groups, state, heads, heads per group, head width)."""
    G, H = cfg.ssm_groups, cfg.ssm_heads
    return cfg.d_inner, G, cfg.ssm_state, H, H // G, cfg.ssm_headdim


def ssm_init(gen: torch.Generator, cfg: ModelConfig) -> Mixer:
    """The reference's init: A_log = dt_bias = 0, Dskip = 1, conv_w
    0.1-normal, matrices normal(0, 1/fan_in); drawn from ``gen``."""
    D = cfg.d_model
    di, G, N, H, _, _ = _dims(cfg)
    conv_dim = di + 2 * G * N
    dt, dev = L.dtype_of(cfg), gen.device
    conv_w = torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                         dtype=torch.float32, device=dev) * 0.1

    def f32(v, n):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    return Mixer(norm=L.rms_norm_init(di, dev),
                 in_proj=L.dense_init(gen, (D, 2 * di + 2 * G * N + H),
                                      dtype=dt),
                 conv_w=conv_w.to(dt), conv_b=f32(0.0, conv_dim),
                 dt_bias=f32(0.0, H), A_log=f32(0.0, H), Dskip=f32(1.0, H),
                 out_proj=L.dense_init(gen, (di, D), dtype=dt))


def _causal_conv(x, w, b):
    """Depthwise causal conv1d in x's dtype. x [B,S,C]; w [K,C]."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return y + b.to(y.dtype)


def ssd_chunked(x, dtv, A, B, C, chunk: int, state0=None):
    """SSD over a full sequence.

    x [b,s,g,r,p] (any strides with p contiguous that view as chunks);
    dtv [b,s,g,r] float32; A [g,r]; B, C [b,s,g,n].  Returns (y
    [b,s,g,r,p], final_state [b,g,r,n,p]), both in x's dtype."""
    b, s, g, r, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    nc, q = s // chunk, chunk
    T = b * nc
    dtb = dtv.float().reshape(b, nc, q, g, r)
    dA = dtb * A                                  # [b,nc,q,g,r] (A<0)
    # intra-chunk block: y_intra and the chunk-local end states, float32
    y_intra, S_loc = ssd_scan.ssd_intra(
        x.view(T, q, g * r, p), dtb.view(T, q, g * r), dA.view(T, q, g * r),
        B.view(T, q, g, n), C.view(T, q, g, n), mode="model")
    y_intra = y_intra.view(b, nc, q, g, r, p)
    S_loc = S_loc.view(b, nc, g, r, n, p)
    cs = torch.cumsum(dA, dim=2)                  # within-chunk cumsum
    chunk_decay = torch.exp(torch.clamp(dA.sum(dim=2), -60.0, 0.0))

    # inter-chunk recurrence S_c = S_{c-1} * decay_c + S_loc_c; the state
    # entering chunk c is S_{c-1} (zero for c = 0).  No tensor is written
    # in place: under autograd S_loc is the kernel's saved output.
    acc = S_loc[:, 0]
    if state0 is not None:
        acc = acc + state0.float() * chunk_decay[:, 0][..., None, None]
    states = [torch.zeros_like(acc)]
    for c in range(1, nc):
        states.append(acc)
        acc = acc * chunk_decay[:, c][..., None, None] + S_loc[:, c]
    S_prev = torch.stack(states, dim=1)
    Cb = C.reshape(b, nc, q, g, n)
    y_inter = torch.einsum("bcqgn,bcgrnp->bcqgrp", Cb.float(),
                           S_prev.to(x.dtype).float())
    y_inter = y_inter * torch.exp(torch.clamp(cs, -60.0, 0.0))[..., None]
    y = (y_intra + y_inter).reshape(b, s, g, r, p)
    return y.to(x.dtype), acc.to(x.dtype)


def ssm_apply(p, cfg: ModelConfig, u, state=None, return_state=False):
    """Full-sequence mamba2 mixer. u [B,S,D] -> [B,S,D] (and the final
    state [B,G,r,N,P] in u's dtype with ``return_state``)."""
    B_, S, D = u.shape
    di, G, N, H, r, pdim = _dims(cfg)
    zxbcdt = L.matmul(u, p.in_proj)
    z, xBC, dtv = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    xBC = F.silu(_causal_conv(xBC, p.conv_w, p.conv_b).float()).to(u.dtype)
    x, Bmat, Cmat = torch.split(xBC, [di, G * N, G * N], dim=-1)
    x = x.view(B_, S, G, r, pdim)
    Bmat = Bmat.view(B_, S, G, N)
    Cmat = Cmat.view(B_, S, G, N)
    dtv = F.softplus(dtv.float() + p.dt_bias).view(B_, S, G, r)
    A = -torch.exp(p.A_log).view(G, r)
    y, fstate = ssd_chunked(x, dtv, A, Bmat, Cmat, cfg.ssm_chunk,
                            state0=state)
    y = y + (p.Dskip.view(G, r)[None, None, :, :, None]
             * x.float()).to(y.dtype)
    y = y.reshape(B_, S, di)
    y = L.rms_norm(p.norm, y * F.silu(z.float()).to(y.dtype), cfg.norm_eps)
    out = L.matmul(y, p.out_proj)
    if return_state:
        return out, fstate
    return out


# ---------------------------------------------------------------- decode


def ssm_init_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device=None):
    di, G, N, _, r, pdim = _dims(cfg)
    conv_dim = di + 2 * G * N
    return {"state": torch.zeros((batch, G, r, N, pdim), dtype=dtype,
                                 device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=dtype, device=device)}


@torch.no_grad()
def ssm_decode_step(p, cfg: ModelConfig, cache, u):
    """u [B,1,D] -> (out [B,1,D], new cache).  The state is updated in
    float32 and stored in the cache's dtype, as the reference does."""
    B_ = u.shape[0]
    di, G, N, H, r, pdim = _dims(cfg)
    zxbcdt = L.matmul(u, p.in_proj)[:, 0]
    z, xBC, dtv = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    # conv over (cached K-1 inputs, current)
    hist = torch.cat([cache["conv"], xBC[:, None, :]], dim=1)
    xBC_c = torch.sum(hist * p.conv_w[None], dim=1) + p.conv_b.to(u.dtype)
    xBC_c = F.silu(xBC_c.float()).to(u.dtype)
    x, Bmat, Cmat = torch.split(xBC_c, [di, G * N, G * N], dim=-1)
    x = x.reshape(B_, G, r, pdim)
    Bmat = Bmat.reshape(B_, G, N)
    Cmat = Cmat.reshape(B_, G, N)
    dtv = F.softplus(dtv.float() + p.dt_bias).view(B_, G, r)
    A = -torch.exp(p.A_log).view(G, r)
    dA = torch.exp(dtv * A)                                # [B,G,r]
    upd = torch.einsum("bgn,bgr,bgrp->bgrnp", Bmat.float(), dtv, x.float())
    state = cache["state"].float() * dA[..., None, None] + upd
    y = torch.einsum("bgn,bgrnp->bgrp", Cmat.float(), state)
    y = y + p.Dskip.view(G, r)[None, :, :, None] * x.float()
    y = y.reshape(B_, di).to(u.dtype)
    y = L.rms_norm(p.norm, y * F.silu(z.float()).to(u.dtype), cfg.norm_eps)
    out = L.matmul(y[:, None, :], p.out_proj)
    return out, {"state": state.to(cache["state"].dtype),
                 "conv": hist[:, 1:]}


# ---------------------------------------------------------------- model


def block_init(gen: torch.Generator, cfg: ModelConfig) -> Block:
    return Block(ln=L.rms_norm_init(cfg.d_model, gen.device),
                 mixer=ssm_init(gen, cfg))


def init(gen: torch.Generator, cfg: ModelConfig) -> SSM:
    """Random parameters drawn from ``gen``, on its device."""
    return SSM(embed=L.embed_init(gen, cfg),
               layers=[block_init(gen, cfg) for _ in range(cfg.n_layers)],
               ln_f=L.rms_norm_init(cfg.d_model, gen.device))


def _layer(lp: Block, cfg: ModelConfig, x):
    return x + ssm_apply(lp.mixer, cfg, L.rms_norm(lp.ln, x, cfg.norm_eps))


def _hidden(params: SSM, cfg: ModelConfig, tokens, remat: bool = False):
    """The residual stream after the last layer, [B,S,D]; ``remat``: see
    ``L.remat``."""
    x = L.embed_apply(params.embed, tokens)
    for lp in params.layers:
        x = L.remat(_layer, remat, lp, cfg, x)
    return x


def forward(params: SSM, cfg: ModelConfig, tokens, remat: bool = True):
    """tokens [B,S] -> logits [B,S,V] (float32).  Under autograd with
    ``remat`` each layer is recomputed in the backward pass."""
    x = L.rms_norm(params.ln_f, _hidden(params, cfg, tokens, remat),
                   cfg.norm_eps)
    return L.logits_apply(params.embed, x)


@torch.no_grad()
def prefill(params: SSM, cfg: ModelConfig, tokens):
    """The logits of the last position [B,1,V] and no cache, as the
    reference's prefill for the ssm family returns (``model.py:111-114``):
    its decode starts from ``init_cache``.  Only the last position's
    logits are computed; they equal ``forward``'s."""
    x = _hidden(params, cfg, tokens)[:, -1:]
    x = L.rms_norm(params.ln_f, x, cfg.norm_eps)
    return L.logits_apply(params.embed, x), None


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None):
    """Zero states for every layer; O(1) in ``seq_len``."""
    del seq_len
    c = ssm_init_cache(cfg, batch, dtype, device)
    return {k: torch.zeros((cfg.n_layers,) + v.shape, dtype=dtype,
                           device=device) for k, v in c.items()}


@torch.no_grad()
def decode_step(params: SSM, cfg: ModelConfig, cache, tokens):
    """One decode step.  tokens [B,1].  Returns (logits [B,1,V] float32,
    cache), the cache updated in place."""
    x = L.embed_apply(params.embed, tokens)
    for i, lp in enumerate(params.layers):
        h = L.rms_norm(lp.ln, x, cfg.norm_eps)
        out, c = ssm_decode_step(lp.mixer, cfg, {"state": cache["state"][i],
                                                 "conv": cache["conv"][i]}, h)
        cache["state"][i] = c["state"]
        cache["conv"][i] = c["conv"]
        x = x + out
    x = L.rms_norm(params.ln_f, x, cfg.norm_eps)
    return L.logits_apply(params.embed, x), cache
