"""Decoder-only transformer (dense family); the port of
``repro.models.transformer``.

Layers are a ``ModuleList`` of ``Block``s run in a Python loop (the
reference scans a stacked pytree).  The KV cache keeps the reference's
layout, ``{"k": [L,B,S,K,hd], "v": [L,B,S,K,hd]}``, so caches compare
directly; ``prefill`` and ``decode_step`` update a cache they are given
IN PLACE and return it.  Decode views each layer's cache as pages of
``page`` positions (``TOKENS_PER_PAGE`` by default, the serving stack's
page), so the cache length must be a multiple of the page size.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

TOKENS_PER_PAGE = 128


class Block(nn.Module):
    def __init__(self, ln1, attn, ln2, ffn):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.ffn = ln1, attn, ln2, ffn


class Transformer(nn.Module):
    """The parameters of a dense model: embed, layers, ln_f."""

    def __init__(self, embed, layers, ln_f):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.ln_f = ln_f


def block_init(gen: torch.Generator, cfg: ModelConfig) -> Block:
    dev = gen.device
    return Block(ln1=L.rms_norm_init(cfg.d_model, dev),
                 attn=L.attn_init(gen, cfg),
                 ln2=L.rms_norm_init(cfg.d_model, dev),
                 ffn=L.mlp_init(gen, cfg))


def init(gen: torch.Generator, cfg: ModelConfig) -> Transformer:
    """Random parameters drawn from ``gen``, on its device."""
    return Transformer(embed=L.embed_init(gen, cfg),
                       layers=[block_init(gen, cfg)
                               for _ in range(cfg.n_layers)],
                       ln_f=L.rms_norm_init(cfg.d_model, gen.device))


def _block(lp: Block, cfg: ModelConfig, x, positions, cos_sin):
    h = L.rms_norm(lp.ln1, x, cfg.norm_eps)
    a, kv = L.attn_apply(lp.attn, cfg, h, positions, cos_sin=cos_sin)
    x = x + a
    h = L.rms_norm(lp.ln2, x, cfg.norm_eps)
    return x + L.mlp_apply(lp.ffn, h), kv


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None, :].expand(B, S)


@torch.no_grad()
def forward(params: Transformer, cfg: ModelConfig, tokens):
    """Full-sequence forward: tokens [B,S] -> logits [B,S,V] (float32)."""
    x = L.embed_apply(params.embed, tokens)
    positions = _positions(tokens)
    cos_sin = L.rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
    for lp in params.layers:
        x, _ = _block(lp, cfg, x, positions, cos_sin)
    x = L.rms_norm(params.ln_f, x, cfg.norm_eps)
    return L.logits_apply(params.embed, x)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None):
    """KV cache ``{"k", "v"}``, each [L,B,S,K,hd] of zeros."""
    L.check_ported(cfg)
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.no_grad()
def prefill(params: Transformer, cfg: ModelConfig, tokens, cache=None):
    """Forward over the prompt that also fills the KV cache.

    tokens [B,S].  Returns (logits of the last position [B,1,V] float32,
    cache).  With ``cache=None`` the cache is new, [L,B,S,K,hd] in the
    activations' dtype, as the reference returns it; a cache from
    ``init_cache`` with room for at least S positions is filled at
    positions [0, S) in place instead, ready for ``decode_step``."""
    B, S = tokens.shape
    if cache is None:
        cache = init_cache(cfg, B, S, L.dtype_of(cfg), tokens.device)
    elif cache["k"].shape[2] < S:
        raise ValueError(f"the cache holds {cache['k'].shape[2]} positions, "
                         f"the prompt has {S}")
    x = L.embed_apply(params.embed, tokens)
    positions = _positions(tokens)
    cos_sin = L.rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
    for i, lp in enumerate(params.layers):
        x, (k, v) = _block(lp, cfg, x, positions, cos_sin)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    x = L.rms_norm(params.ln_f, x, cfg.norm_eps)
    return L.logits_apply(params.embed, x[:, -1:]), cache


@torch.no_grad()
def decode_step(params: Transformer, cfg: ModelConfig, cache, tokens, pos,
                *, page: int = TOKENS_PER_PAGE):
    """One decode step.  tokens [B,1]; pos [B].  Returns (logits [B,1,V]
    float32, cache), the cache updated in place at ``pos``."""
    x = L.embed_apply(params.embed, tokens)
    cos_sin = L.rope_cos_sin(pos[:, None], cfg.hd, cfg.rope_theta)
    for i, lp in enumerate(params.layers):
        h = L.rms_norm(lp.ln1, x, cfg.norm_eps)
        a, _, _ = L.attn_decode(lp.attn, cfg, h, pos, cache["k"][i],
                                cache["v"][i], page=page, cos_sin=cos_sin)
        x = x + a
        h = L.rms_norm(lp.ln2, x, cfg.norm_eps)
        x = x + L.mlp_apply(lp.ffn, h)
    x = L.rms_norm(params.ln_f, x, cfg.norm_eps)
    return L.logits_apply(params.embed, x), cache
