"""Public wrappers around the kernels, with the signatures of
``repro.kernels.ops``; the port's copy of it.

The path follows the tensors' device: the CUDA kernel on ``cuda``, the
plain PyTorch version on ``cpu`` (the choice is made in each kernel's
wrapper).
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q, k, v, *, causal=True, window=None):
    """q [B,S,H,hd]; k,v [B,Sk,K,hd] (model layout). Returns [B,S,H,hd].

    The swaps are views: the kernel reads any strides with hd contiguous,
    and its output is laid out [B,S,H,hd] in memory."""
    o = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2)


def paged_attention(q, k_pages, v_pages, tables, lens):
    """q [B,H,hd]; pages [P,page,K,hd]; tables [B,nb]; lens [B]."""
    return _pa.paged_attention(q, k_pages, v_pages, tables, lens)


def ssd_intra(x, dt, dA, B, C):
    """The Pallas kernel's contract: x [T,q,R,p]; dt, dA [T,q,R,1] float32;
    B, C [T,q,R,n] per head.  Returns (y [T,q,R,p], S_loc [T,R,n,p]) in
    x's dtype, the weights kept in float32 (``pallas`` rounding)."""
    return _ssd.ssd_intra(x, dt[..., 0], dA[..., 0], B, C, mode="pallas")
