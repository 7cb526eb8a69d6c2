"""Encoder-decoder backbone (seamless-m4t-medium); the port of
``repro.models.encdec``.

The audio frontend is a stub, as in the reference: ``src_embeds`` are
precomputed frame embeddings [B, S_src, D].  The encoder is
bidirectional self-attention with RoPE (the flash kernel, non-causal);
each decoder layer runs causal self-attention, then cross-attention on
the encoder's output (the flash kernel over S_src keys, no rotation, no
mask), then the MLP.

Decode reads the self KV cache and a cross cache ``xk``/``xv`` of the
same length.  As in the reference, nothing here fills the cross cache:
``init_cache`` makes it zeros and ``decode_step`` attends over every
slot of it with a zero bias, filled or not (the paged kernel with
``lens`` = the cache length).  A caller that wants the encoder's keys
there projects them itself (``cross.wk``/``wv`` of each decoder layer).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import TOKENS_PER_PAGE


class EncBlock(nn.Module):
    def __init__(self, ln1, attn, ln2, mlp):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class DecBlock(nn.Module):
    def __init__(self, ln1, attn, lnx, cross, ln2, mlp):
        super().__init__()
        self.ln1, self.attn, self.lnx, self.cross = ln1, attn, lnx, cross
        self.ln2, self.mlp = ln2, mlp


class EncDec(nn.Module):
    """embed, enc (encoder blocks), enc_ln, dec (decoder blocks), ln_f."""

    def __init__(self, embed, enc, enc_ln, dec, ln_f):
        super().__init__()
        self.embed = embed
        self.enc = nn.ModuleList(enc)
        self.enc_ln = enc_ln
        self.dec = nn.ModuleList(dec)
        self.ln_f = ln_f


def init(gen: torch.Generator, cfg: ModelConfig) -> EncDec:
    """Random parameters drawn from ``gen``, on its device."""
    D, dev = cfg.d_model, gen.device

    def norm():
        return L.rms_norm_init(D, dev)

    embed = L.embed_init(gen, cfg)
    enc = [EncBlock(ln1=norm(), attn=L.attn_init(gen, cfg), ln2=norm(),
                    mlp=L.mlp_init(gen, cfg))
           for _ in range(cfg.n_enc_layers)]
    dec = [DecBlock(ln1=norm(), attn=L.attn_init(gen, cfg), lnx=norm(),
                    cross=L.attn_init(gen, cfg), ln2=norm(),
                    mlp=L.mlp_init(gen, cfg))
           for _ in range(cfg.n_layers)]
    return EncDec(embed=embed, enc=enc, enc_ln=norm(), dec=dec, ln_f=norm())


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device)[None, :].expand(B, S)


def _enc_layer(lp: EncBlock, cfg: ModelConfig, x, pos, cos_sin):
    h = L.rms_norm(lp.ln1, x, cfg.norm_eps)
    a, _ = L.attn_apply(lp.attn, cfg, h, pos, causal=False, cos_sin=cos_sin)
    x = x + a
    return x + L.mlp_apply(lp.mlp, L.rms_norm(lp.ln2, x, cfg.norm_eps))


def _dec_layer(lp: DecBlock, cfg: ModelConfig, x, enc, pos, cos_sin):
    h = L.rms_norm(lp.ln1, x, cfg.norm_eps)
    a, _ = L.attn_apply(lp.attn, cfg, h, pos, cos_sin=cos_sin)
    x = x + a
    h = L.rms_norm(lp.lnx, x, cfg.norm_eps)
    a, _ = L.attn_apply(lp.cross, cfg, h, pos, kv=enc)
    x = x + a
    return x + L.mlp_apply(lp.mlp, L.rms_norm(lp.ln2, x, cfg.norm_eps))


def encode(params: EncDec, cfg: ModelConfig, src_embeds, remat: bool = True):
    """src_embeds [B,Ss,D] -> the encoder's output [B,Ss,D].  Under
    autograd with ``remat`` each layer is recomputed in the backward
    pass (``L.remat``)."""
    B, Ss, _ = src_embeds.shape
    x = src_embeds
    pos = _positions(B, Ss, x.device)
    cos_sin = L.rope_cos_sin(pos, cfg.hd, cfg.rope_theta)
    for lp in params.enc:
        x = L.remat(_enc_layer, remat, lp, cfg, x, pos, cos_sin)
    return L.rms_norm(params.enc_ln, x, cfg.norm_eps)


def forward(params: EncDec, cfg: ModelConfig, tokens, src_embeds,
            remat: bool = True):
    """Teacher-forced forward: tokens [B,St] over src_embeds [B,Ss,D] ->
    decoder logits [B,St,V] (float32)."""
    enc = encode(params, cfg, src_embeds, remat)
    B, St = tokens.shape
    pos = _positions(B, St, tokens.device)
    cos_sin = L.rope_cos_sin(pos, cfg.hd, cfg.rope_theta)
    x = L.embed_apply(params.embed, tokens)
    for lp in params.dec:
        x = L.remat(_dec_layer, remat, lp, cfg, x, enc, pos, cos_sin)
    x = L.rms_norm(params.ln_f, x, cfg.norm_eps)
    return L.logits_apply(params.embed, x)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None):
    """Self K/V (``k``, ``v``) and cross K/V (``xk``, ``xv``), each
    [L,B,S,K,hd] of zeros."""
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.hd)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name in ("k", "v", "xk", "xv")}


@torch.no_grad()
def decode_step(params: EncDec, cfg: ModelConfig, cache, tokens, pos, *,
                page: int = TOKENS_PER_PAGE):
    """One decoder step against the self KV (updated in place at ``pos``)
    and the cross cache as it stands.  tokens [B,1]; pos [B].  Returns
    (logits [B,1,V] float32, cache)."""
    B = tokens.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    x = L.embed_apply(params.embed, tokens)
    cos_sin = L.rope_cos_sin(pos[:, None], hd, cfg.rope_theta)
    xlens = torch.full((B,), cache["xk"].shape[2], dtype=torch.int32,
                       device=x.device)
    for i, lp in enumerate(params.dec):
        h = L.rms_norm(lp.ln1, x, cfg.norm_eps)
        a, _, _ = L.attn_decode(lp.attn, cfg, h, pos, cache["k"][i],
                                cache["v"][i], page=page, cos_sin=cos_sin)
        x = x + a
        # cross-attention reads the static cross K/V (no rope, no update)
        h = L.rms_norm(lp.lnx, x, cfg.norm_eps)
        q = L.matmul(h, lp.cross.wq).reshape(B, H, hd)
        o = L.paged_identity(q, cache["xk"][i], cache["xv"][i], xlens, page)
        x = x + L.matmul(o.reshape(B, 1, H * hd), lp.cross.wo)
        h = L.rms_norm(lp.ln2, x, cfg.norm_eps)
        x = x + L.mlp_apply(lp.mlp, h)
    x = L.rms_norm(params.ln_f, x, cfg.norm_eps)
    return L.logits_apply(params.embed, x), cache
