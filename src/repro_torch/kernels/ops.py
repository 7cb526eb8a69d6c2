"""Public wrappers around the attention kernels, in the model's layout;
the port's copy of ``repro.kernels.ops``.

The path follows the tensors' device: the CUDA kernel on ``cuda``, the
plain PyTorch version on ``cpu`` (the choice is made in each kernel's
wrapper).
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa


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
