"""Plain PyTorch versions of the kernels (float32 math, no tiling); the
port's copy of ``repro.kernels.ref``.

Each computes in float32 and casts back to the input's dtype, as the JAX
oracles do (``ssd_intra_plain`` in its ``model`` mode keeps float32, as
the model does).  The kernel wrappers run these for CPU tensors, and
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


def _decay(d):
    return torch.exp(torch.clamp(d, -60.0, 0.0))


def ssd_intra_reference(x, dt, dA, B, C):
    """Intra-chunk SSD block for ONE (chunk, head): x [q,p]; dt, dA [q];
    B, C [q,n].  Returns (y [q,p], S_loc [n,p]) in x's dtype."""
    q = x.shape[0]
    cs = torch.cumsum(dA.float(), 0)
    CB = C.float() @ B.float().T
    L = _decay(cs[:, None] - cs[None, :])
    L = L * torch.tril(torch.ones((q, q), device=x.device))
    W = CB * L * dt.float()[None, :]
    y = W @ x.float()
    decay_end = _decay(cs[-1] - cs)
    S_loc = torch.einsum("qn,q,qp->np", B.float(), decay_end * dt.float(),
                         x.float())
    return y.to(x.dtype), S_loc.to(x.dtype)


def ssd_intra_plain(x, dt, dA, B, C, *, mode="pallas"):
    """The intra-chunk SSD block over every chunk and head, with the
    kernel's signature: x [T,q,R,p]; dt, dA [T,q,R] float32; B, C
    [T,q,G,n], head h reading group h // (R // G).  Returns (y [T,q,R,p],
    S_loc [T,R,n,p]).

    ``mode`` says where x's dtype rounds (nowhere in float32):
    ``pallas`` as the Pallas body (``repro/kernels/ssd_scan.py:21-45``):
    the weights W = CB * L * dt and B * decay_end * dt in float32, y and S
    cast to x's dtype; ``model`` as ``repro/models/ssm.py:65-84``: CB, L
    and dt each cast to x's dtype and W rounded after each multiply,
    decay_end * dt rounded, y and S left in float32."""
    T, q, R, p = x.shape
    G = B.shape[2]
    r = R // G
    dtp = x.dtype if mode == "model" else torch.float32

    def rnd(t):
        return t.to(dtp).float()

    cs = torch.cumsum(dA, 1).permute(0, 2, 1)                  # [T,R,q]
    CB = torch.einsum("tign,tjgn->tgij", C.float(), B.float())
    CB = CB.repeat_interleave(r, dim=1)                        # [T,R,q,q]
    L = _decay(cs[..., :, None] - cs[..., None, :])
    L = L * torch.tril(torch.ones((q, q), device=x.device))
    dtj = dt.permute(0, 2, 1)[:, :, None, :]                   # [T,R,1,q]
    W = rnd(rnd(rnd(CB) * rnd(L)) * rnd(dtj))
    y = torch.einsum("trij,tjrp->tirp", W, x.float())
    w = rnd(_decay(cs[..., -1:] - cs) * dt.permute(0, 2, 1))   # [T,R,q]
    Bw = B.float().repeat_interleave(r, dim=2) * w.permute(0, 2, 1)[..., None]
    S = torch.einsum("tqrn,tqrp->trnp", Bw, x.float())
    out = x.dtype if mode == "pallas" else torch.float32
    return y.to(out), S.to(out)
