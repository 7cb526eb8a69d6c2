"""The Mamba-2 SSD intra-chunk block as a CUDA kernel written by hand for
Hopper (``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py:49``
(``ssd_intra``; body ``_kernel`` at :21).  The port's
``models.ssm.ssd_chunked`` runs it once per mamba2 layer, for every chunk
and head of the prompt.

``ssd_intra`` picks the path from the device of the tensors it is given:
on CUDA tensors it launches the kernel (or raises); on CPU tensors it runs
the plain PyTorch version, ``ref.ssd_intra_plain``.  No flag or
environment variable chooses the path.  ``mode`` says where bf16 rounds
(see ``ref.ssd_intra_plain``); both paths take it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# kernel launches made by ssd_intra since import
LAUNCHES = 0

MAX_Q, MAX_N, MAX_P = 128, 128, 64  # the sizes the kernel's tiles hold
HEADS_PER_BLOCK = 8                 # heads of one group a block loops over
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MODES = {"pallas": 0, "model": 1}

_p, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int32


class _Args(ctypes.Structure):
    _fields_ = ([(n, _p) for n in ("x", "dt", "dA", "B", "C", "y", "S")]
                + [(f"{t}_s{d}", _ll) for t, dims in
                   (("x", "tqh"), ("dt", "tqh"), ("dA", "tqh"), ("B", "tqg"),
                    ("C", "tqg"), ("y", "tqh"), ("S", "thn"))
                   for d in dims]
                + [(n, _i) for n in ("T", "q", "R", "G", "p", "n",
                                     "heads_per_block", "mode")])


_LIB = None


def _lib() -> ctypes.CDLL:
    """The compiled kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = build.load("ssd_scan")
        lib.ssd_intra_args_size.restype = ctypes.c_int
        lib.ssd_intra_launch.argtypes = [_Args, ctypes.c_int, ctypes.c_void_p]
        lib.ssd_intra_launch.restype = ctypes.c_int
        lib.ssd_intra_error_string.argtypes = [ctypes.c_int]
        lib.ssd_intra_error_string.restype = ctypes.c_char_p
        got = lib.ssd_intra_args_size()
        if got != ctypes.sizeof(_Args):
            raise RuntimeError(f"SsdArgs is {got} bytes in C, "
                               f"{ctypes.sizeof(_Args)} in ctypes")
        _LIB = lib
    return _LIB


def check(x, dt, dA, B, C, mode):
    """Shapes the function takes (both paths): (T, q, R, p, G, n)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {list(MODES)}, not {mode!r}")
    if x.dim() != 4 or dt.dim() != 3 or dA.dim() != 3 or B.dim() != 4 \
            or C.dim() != 4:
        raise ValueError("x must be [T,q,R,p], dt and dA [T,q,R], B and C "
                         "[T,q,G,n]")
    T, q, R, p = x.shape
    G, n = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (T, q, R) or tuple(dA.shape) != (T, q, R) \
            or tuple(B.shape[:2]) != (T, q) or tuple(C.shape) != tuple(B.shape):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, dA "
                         f"{tuple(dA.shape)}, B {tuple(B.shape)} and C "
                         f"{tuple(C.shape)} do not fit together")
    if G == 0 or R % G:
        raise ValueError(f"{R} heads are not a multiple of {G} groups")
    if dt.dtype != torch.float32 or dA.dtype != torch.float32:
        raise TypeError(f"dt and dA must be float32, not {dt.dtype} and "
                        f"{dA.dtype}")
    for name, t in (("B", B), ("C", C)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    return T, q, R, p, G, n


def launch(x, dt, dA, B, C, *, mode="pallas"):
    """The CUDA kernel on CUDA tensors; raises on anything it does not
    take, and when the launch is refused.  Returns (y [T,q,R,p], S
    [T,R,n,p]), in x's dtype (``pallas``) or float32 (``model``)."""
    global LAUNCHES
    T, q, R, p, G, n = check(x, dt, dA, B, C, mode)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the ssd_intra kernel runs on CUDA tensors, x is "
                         f"on {dev}")
    for name, t in (("dt", dt), ("dA", dA), ("B", B), ("C", C)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in DTYPES:
        raise TypeError(f"the kernel takes {list(DTYPES)}, not {x.dtype}")
    if not (1 <= q <= MAX_Q and 1 <= n <= MAX_N and 1 <= p <= MAX_P):
        raise ValueError(f"the kernel takes q <= {MAX_Q}, n <= {MAX_N} and "
                         f"p <= {MAX_P}, not q={q}, n={n}, p={p}")
    if T > 2**31 - 1 or G > 65535:
        raise ValueError(f"T={T} or G={G} is beyond the grid")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    out = x.dtype if mode == "pallas" else torch.float32
    y = torch.empty((T, q, R, p), dtype=out, device=dev)
    S = torch.empty((T, R, n, p), dtype=out, device=dev)
    if T == 0 or R == 0:
        return y, S
    strides = [t.stride(d) for t in (x, dt, dA, B, C, y) for d in (0, 1, 2)]
    strides += [S.stride(0), S.stride(1), S.stride(2)]
    args = _Args(x.data_ptr(), dt.data_ptr(), dA.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(), S.data_ptr(), *strides,
                 T, q, R, G, p, n, HEADS_PER_BLOCK, MODES[mode])
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.ssd_intra_launch(args, DTYPES[x.dtype],
                                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_intra kernel launch failed: CUDA error {err} "
            f"({lib.ssd_intra_error_string(err).decode()})")
    LAUNCHES += 1
    return y, S


def ssd_intra(x, dt, dA, B, C, *, mode: str = "pallas"):
    """x [T,q,R,p]; dt, dA [T,q,R] float32; B, C [T,q,G,n] with head h
    reading group h // (R // G).  Returns (y [T,q,R,p], S [T,R,n,p]).

    On the card this launches the CUDA kernel; on the CPU it runs
    ``ref.ssd_intra_plain``."""
    if x.device.type == "cuda":
        return launch(x, dt, dA, B, C, mode=mode)
    if x.device.type == "cpu":
        check(x, dt, dA, B, C, mode)
        return ref.ssd_intra_plain(x, dt, dA, B, C, mode=mode)
    raise ValueError(f"no ssd_intra path for device {x.device}")
