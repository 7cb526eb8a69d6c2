"""Decoder-only transformer (the dense, moe and vlm families); the port of
``repro.models.transformer``.

Covers granite-3-2b, qwen3-32b (qk_norm), phi3-medium-14b, yi-6b,
mixtral-8x7b (sliding window, top-2 experts), granite-moe-1b-a400m (top-8
experts) and qwen2-vl-7b (M-RoPE over ``positions3``, vision embeddings
in place of the first rows).  The FFN follows the family: ``MLP``, or
``MoE`` (``models.moe``) for moe, as the reference's ``ffn_apply`` hook
chooses.

Layers are a ``ModuleList`` of ``Block``s run in a Python loop (the
reference scans a stacked pytree).  The KV cache keeps the reference's
layout, ``{"k": [L,B,S,K,hd], "v": [L,B,S,K,hd]}``, so caches compare
directly; ``prefill`` and ``decode_step`` update a cache they are given
IN PLACE and return it.  Decode views each layer's cache as pages of
``page`` positions (``TOKENS_PER_PAGE`` by default, the serving stack's
page), so the cache length must be a multiple of the page size.

A config with a ``window`` keeps a ring of S = min(seq_len, window)
slots, as the reference: a prompt longer than the window leaves its last
``window`` keys at slots 0..window-1 (position S_prompt - window + i at
slot i), while decode writes position p at slot p % S.  The two disagree
on which slot holds which position once the prompt passed the window;
decode attends over every filled slot all the same, so the port keeps
the reference's layout as it is.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe

TOKENS_PER_PAGE = 128


class Block(nn.Module):
    def __init__(self, ln1, attn, ln2, ffn):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.ffn = ln1, attn, ln2, ffn


class Transformer(nn.Module):
    """The parameters of a decoder-only model: embed, layers, ln_f."""

    def __init__(self, embed, layers, ln_f):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.ln_f = ln_f


def ffn_apply(p, cfg: ModelConfig, x):
    """The family's FFN: the experts for moe, the SwiGLU MLP elsewhere."""
    if cfg.family == "moe":
        return moe.moe_apply(p, x, cfg)
    return L.mlp_apply(p, x)


def block_init(gen: torch.Generator, cfg: ModelConfig) -> Block:
    dev = gen.device
    ffn_init = moe.moe_init if cfg.family == "moe" else L.mlp_init
    return Block(ln1=L.rms_norm_init(cfg.d_model, dev),
                 attn=L.attn_init(gen, cfg),
                 ln2=L.rms_norm_init(cfg.d_model, dev),
                 ffn=ffn_init(gen, cfg))


def init(gen: torch.Generator, cfg: ModelConfig) -> Transformer:
    """Random parameters drawn from ``gen``, on its device."""
    return Transformer(embed=L.embed_init(gen, cfg),
                       layers=[block_init(gen, cfg)
                               for _ in range(cfg.n_layers)],
                       ln_f=L.rms_norm_init(cfg.d_model, gen.device))


def _block(lp: Block, cfg: ModelConfig, x, positions, cos_sin):
    h = L.rms_norm(lp.ln1, x, cfg.norm_eps)
    a, kv = L.attn_apply(lp.attn, cfg, h, positions, window=cfg.window,
                         cos_sin=cos_sin)
    x = x + a
    h = L.rms_norm(lp.ln2, x, cfg.norm_eps)
    return x + ffn_apply(lp.ffn, cfg, h), kv


def _embed(params: Transformer, cfg: ModelConfig, tokens, positions3,
           input_embeds):
    """Embeddings, positions 0..S-1 and the layers' shared cos/sin."""
    B, S = tokens.shape
    x = L.embed_apply(params.embed, tokens, input_embeds)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    return x, positions, L.positional_cos_sin(cfg, positions, positions3)


@torch.no_grad()
def forward(params: Transformer, cfg: ModelConfig, tokens, *,
            positions3=None, input_embeds=None):
    """Full-sequence forward: tokens [B,S] -> logits [B,S,V] (float32).
    ``positions3`` [3,B,S]: M-RoPE's streams; ``input_embeds`` [B,P,D]
    replace the first P embedding rows."""
    x, positions, cos_sin = _embed(params, cfg, tokens, positions3,
                                   input_embeds)
    for lp in params.layers:
        x, _ = _block(lp, cfg, x, positions, cos_sin)
    x = L.rms_norm(params.ln_f, x, cfg.norm_eps)
    return L.logits_apply(params.embed, x)


def cache_slots(cfg: ModelConfig, seq_len: int) -> int:
    """Slots a cache for ``seq_len`` positions keeps: a ring of
    min(seq_len, window) with a window, else seq_len."""
    return min(seq_len, cfg.window) if cfg.window else seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None):
    """KV cache ``{"k", "v"}``, each [L,B,S,K,hd] of zeros with S =
    ``cache_slots(cfg, seq_len)``."""
    shape = (cfg.n_layers, batch, cache_slots(cfg, seq_len), cfg.n_kv_heads,
             cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.no_grad()
def prefill(params: Transformer, cfg: ModelConfig, tokens, cache=None, *,
            positions3=None, input_embeds=None):
    """Forward over the prompt that also fills the KV cache.

    tokens [B,S].  Returns (logits of the last position [B,1,V] float32,
    cache).  With ``cache=None`` the cache is new, [L,B,S',K,hd] in the
    activations' dtype with S' = ``cache_slots(cfg, S)``, as the reference
    returns it; a cache from ``init_cache`` is filled in place instead,
    ready for ``decode_step``: positions [0, S) where it has room for
    them, or, in a ring the prompt overflows, the last ``window`` keys at
    slots 0..window-1 (the reference's layout)."""
    B, S = tokens.shape
    keep = cache_slots(cfg, S)
    if cache is None:
        cache = init_cache(cfg, B, S, L.dtype_of(cfg), tokens.device)
    elif cache["k"].shape[2] < keep:
        raise ValueError(f"the cache holds {cache['k'].shape[2]} positions, "
                         f"the prompt leaves {keep}")
    x, positions, cos_sin = _embed(params, cfg, tokens, positions3,
                                   input_embeds)
    for i, lp in enumerate(params.layers):
        x, (k, v) = _block(lp, cfg, x, positions, cos_sin)
        cache["k"][i, :, :keep] = k[:, S - keep:]
        cache["v"][i, :, :keep] = v[:, S - keep:]
    x = L.rms_norm(params.ln_f, x, cfg.norm_eps)
    return L.logits_apply(params.embed, x[:, -1:]), cache


@torch.no_grad()
def decode_step(params: Transformer, cfg: ModelConfig, cache, tokens, pos,
                *, page: int = TOKENS_PER_PAGE, positions3=None):
    """One decode step.  tokens [B,1]; pos [B]; ``positions3`` [3,B,1]
    for M-RoPE.  Returns (logits [B,1,V] float32, cache), the cache
    updated in place at ``pos`` (``pos % S`` in a ring)."""
    x = L.embed_apply(params.embed, tokens)
    cos_sin = L.positional_cos_sin(cfg, pos[:, None], positions3)
    for i, lp in enumerate(params.layers):
        h = L.rms_norm(lp.ln1, x, cfg.norm_eps)
        a, _, _ = L.attn_decode(lp.attn, cfg, h, pos, cache["k"][i],
                                cache["v"][i], page=page, window=cfg.window,
                                cos_sin=cos_sin)
        x = x + a
        h = L.rms_norm(lp.ln2, x, cfg.norm_eps)
        x = x + ffn_apply(lp.ffn, cfg, h)
    x = L.rms_norm(params.ln_f, x, cfg.norm_eps)
    return L.logits_apply(params.embed, x), cache
