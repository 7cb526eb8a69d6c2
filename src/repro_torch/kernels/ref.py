"""Plain PyTorch versions of the attention kernels (float32 math, no
tiling); the port's copy of ``repro.kernels.ref``.

Each computes in float32 and casts back to the query's dtype, as the
JAX oracles do.  The kernel wrappers run these for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mha_reference(q, k, v, *, causal=True, window=None):
    """q [B,H,S,hd]; k,v [B,K,Sk,hd] (GQA). Returns [B,H,S,hd]."""
    B, H, S, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / (hd ** 0.5)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def paged_attention_reference(q, k_pages, v_pages, tables, lens):
    """q [B,H,hd]; pages [P,page,K,hd]; tables [B,nb]; lens [B]."""
    B, H, hd = q.shape
    P, page, K, _ = k_pages.shape
    G = H // K
    nb = tables.shape[1]
    idx = tables.long()
    # gather the logical KV [B, nb*page, K, hd]
    k = k_pages[idx].reshape(B, nb * page, K, hd).float()
    v = v_pages[idx].reshape(B, nb * page, K, hd).float()
    kf = k.repeat_interleave(G, dim=2)
    vf = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), kf) / (hd ** 0.5)
    tok = torch.arange(nb * page, device=q.device)[None, None, :]
    s = torch.where(tok < lens.to(q.device)[:, None, None], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, vf).to(q.dtype)
