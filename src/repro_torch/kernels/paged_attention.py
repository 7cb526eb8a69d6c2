"""GQA decode attention over a paged KV pool, as a CUDA kernel written by
hand for Hopper (``csrc/paged_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/paged_attention.py:73``
(``paged_attention``; body ``_kernel`` at :28).  The decode attention of
the port's transformer runs through it, one launch per layer and step,
over the layer's cache viewed as pages.

``paged_attention`` picks the path from the device of the tensors it is
given: on CUDA tensors it launches the kernel (or raises); on CPU
tensors it runs the plain PyTorch version,
``ref.paged_attention_reference``.  No flag chooses the path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# kernel launches made by paged_attention since import
LAUNCHES = 0

HEAD_DIMS = (16, 32, 64)    # head widths the kernel is instantiated for
MAX_GROUP = 8               # query heads per kv head the kernel holds
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_p, _i = ctypes.c_void_p, ctypes.c_int32


class _Args(ctypes.Structure):
    _fields_ = ([(n, _p) for n in ("q", "k_pages", "v_pages", "tables",
                                   "lens", "o")]
                + [(n, _i) for n in ("B", "H", "K", "page", "nb")]
                + [("scale", ctypes.c_float)])


_LIB = None


def _lib() -> ctypes.CDLL:
    """The compiled kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = build.load("paged_attention")
        lib.paged_attention_args_size.restype = ctypes.c_int
        lib.paged_attention_max_group.restype = ctypes.c_int
        lib.paged_attention_launch.argtypes = [_Args, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        lib.paged_attention_launch.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        got = lib.paged_attention_args_size()
        if got != ctypes.sizeof(_Args):
            raise RuntimeError(f"PagedArgs is {got} bytes in C, "
                               f"{ctypes.sizeof(_Args)} in ctypes")
        if lib.paged_attention_max_group() != MAX_GROUP:
            raise RuntimeError("MAX_GROUP disagrees with the kernel's GMAX")
        _LIB = lib
    return _LIB


def check(q, k_pages, v_pages, tables, lens):
    """Shapes the function takes (both paths): (B, H, hd, P, page, K, nb)."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be [B,H,hd] and the pages [P,page,K,hd]")
    B, H, hd = q.shape
    P, page, K, khd = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape) or khd != hd:
        raise ValueError(f"q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)} and v_pages "
                         f"{tuple(v_pages.shape)} do not fit together")
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} kv "
                         f"heads")
    if tables.dim() != 2 or tables.shape[0] != B \
            or tuple(lens.shape) != (B,):
        raise ValueError(f"tables must be [B, nb] and lens [B] with B={B}")
    return B, H, hd, P, page, K, tables.shape[1]


def launch(q, k_pages, v_pages, tables, lens):
    """The CUDA kernel on CUDA tensors; raises on anything it does not
    take, and when the launch is refused.  Page ids in ``tables`` must lie
    in [0, P); ``lens`` above nb * page count as nb * page."""
    global LAUNCHES
    B, H, hd, P, page, K, nb = check(q, k_pages, v_pages, tables, lens)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the paged_attention kernel runs on CUDA tensors, "
                         f"q is on {dev}")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("lens", lens)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in (("tables", tables), ("lens", lens)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} is {x.dtype}, want torch.int32")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"v_pages is {v_pages.dtype}, k_pages "
                        f"{k_pages.dtype}")
    for name, x in (("q", q), ("pages", k_pages)):
        if x.dtype not in DTYPES:
            raise TypeError(f"{name}: the kernel takes {list(DTYPES)}, not "
                            f"{x.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head widths {HEAD_DIMS}, not "
                         f"{hd}")
    if H // K > MAX_GROUP:
        raise ValueError(f"the kernel holds at most {MAX_GROUP} query heads "
                         f"per kv head, not {H // K}")
    if B > 65535:
        raise ValueError(f"B={B} must be at most 65535")
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the "
                             f"kernel loads 16 bytes at a time)")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    args = _Args(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), o.data_ptr(),
                 B, H, K, page, nb, 1.0 / (hd ** 0.5))
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.paged_attention_launch(
            args, DTYPES[q.dtype], DTYPES[k_pages.dtype], hd,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {err} "
            f"({lib.paged_attention_error_string(err).decode()})")
    LAUNCHES += 1
    return o


def paged_attention(q, k_pages, v_pages, tables, lens):
    """q [B,H,hd]; k_pages/v_pages [P,page,K,hd]; tables [B,nb] int32
    physical page ids; lens [B] context lengths.  Returns [B,H,hd].

    On the card this launches the CUDA kernel; on the CPU it runs
    ``ref.paged_attention_reference``."""
    if q.device.type == "cuda":
        return launch(q, k_pages, v_pages, tables, lens)
    if q.device.type == "cpu":
        check(q, k_pages, v_pages, tables, lens)
        return ref.paged_attention_reference(q, k_pages, v_pages, tables,
                                             lens)
    raise ValueError(f"no paged_attention path for device {q.device}")
