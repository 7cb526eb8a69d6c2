"""The Mamba-2 SSD intra-chunk block as CUDA kernels written by hand for
Hopper (``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py:49``
(``ssd_intra``; body ``_kernel`` at :21).  The port's
``models.ssm.ssd_chunked`` runs it once per mamba2 layer, for every chunk
and head of the prompt, in serving and in training (``_SsdIntra``).

``ssd_intra`` picks the path from the device of the tensors it is given:
on CUDA tensors it launches the kernel (or raises); on CPU tensors it runs
the plain PyTorch version, ``ref.ssd_intra_plain``.  No flag or
environment variable chooses the path.  ``mode`` says where bf16 rounds
(see ``ref.ssd_intra_plain``); both paths take it.  On the card
``kernel_for`` picks the kernel: bf16 in ``model`` rounding (the mamba2
prefill's call) runs on the tensor cores (``mma_bf16``), every other call
on the CUDA cores (``fma_f32``).  A call that its kernel cannot take
raises; none passes to the other kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# kernel launches made by ssd_intra since import, in all and by kernel
LAUNCHES = 0
LAUNCHES_BY_KERNEL = {"mma_bf16": 0, "fma_f32": 0}

MAX_Q, MAX_N, MAX_P = 128, 128, 64  # the sizes both kernels' tiles hold
KERNELS = {"fma_f32": 0, "mma_bf16": 1}  # the C side's kernel codes
# heads of one group a block loops over: mma_bf16's 10 make mamba2-2.7b's
# prefill (80 heads, 32 chunks) 256 blocks, one wave at 2 blocks an SM
HEADS_PER_BLOCK = {"fma_f32": 8, "mma_bf16": 10}
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
        lib.ssd_intra_launch.argtypes = [_Args, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
        lib.ssd_intra_launch.restype = ctypes.c_int
        lib.ssd_intra_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.ssd_intra_smem_bytes.restype = ctypes.c_int
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


def kernel_for(dtype, mode, q, n, p, strides, ptr_mod16) -> str:
    """The kernel that takes a call: ``"mma_bf16"`` or ``"fma_f32"``;
    raises when neither takes it.

    The rule: bf16 in ``model`` rounding with n and p multiples of 8 runs
    on the tensor cores (``mma_bf16``; any q up to 128, its tiles
    zero-filled past q, n and p).  Every other call runs on the CUDA
    cores (``fma_f32``): float32, whose tolerance bf16 operands cannot
    meet; the ``pallas`` rounding, whose float32 weights no bf16 operand
    holds; n or p off the 8-element chunks.

    ``strides`` are the t, q and h (or g) strides in elements of x, B and
    C, then of y and S; ``ptr_mod16`` the data pointers of x, B, C, y and
    S modulo 16.  ``mma_bf16`` copies and stores rows in 16-byte pieces,
    so it needs both in whole 16-byte units and raises on anything else."""
    if dtype not in DTYPES:
        raise TypeError(f"ssd_intra takes {list(DTYPES)}, not {dtype}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {list(MODES)}, not {mode!r}")
    if not (1 <= q <= MAX_Q and 1 <= n <= MAX_N and 1 <= p <= MAX_P):
        raise ValueError(f"the ssd_intra kernels take q <= {MAX_Q}, n <= "
                         f"{MAX_N} and p <= {MAX_P}, not q={q}, n={n}, p={p}")
    if dtype != torch.bfloat16 or mode != "model" or n % 8 or p % 8:
        return "fma_f32"
    odd = [s for s in strides[:9] if s % 8] + [s for s in strides[9:]
                                               if s % 4]
    if odd:
        raise ValueError(f"the mma_bf16 kernel needs strides in whole "
                         f"16-byte units (x, B, C: multiples of 8 elements;"
                         f" y, S: of 4), got {odd}")
    if any(ptr_mod16):
        raise ValueError(f"the mma_bf16 kernel needs 16-byte aligned data "
                         f"pointers, got offsets {list(ptr_mod16)} modulo 16")
    return "mma_bf16"


def smem_bytes(kernel, q, n, p) -> int:
    """Dynamic shared memory a block of ``kernel`` takes at (q, n, p), as
    the compiled library reports it (builds it at first use)."""
    return _lib().ssd_intra_smem_bytes(KERNELS[kernel], q, n, p,
                                       HEADS_PER_BLOCK[kernel])


def launch(x, dt, dA, B, C, *, mode="pallas"):
    """The CUDA kernel ``kernel_for`` picks, on CUDA tensors; raises on
    anything it does not take, and when the launch is refused.  Returns (y
    [T,q,R,p], S [T,R,n,p]), in x's dtype (``pallas``) or float32
    (``model``)."""
    global LAUNCHES
    T, q, R, p, G, n = check(x, dt, dA, B, C, mode)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the ssd_intra kernel runs on CUDA tensors, x is "
                         f"on {dev}")
    for name, t in (("dt", dt), ("dA", dA), ("B", B), ("C", C)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if T > 2**31 - 1 or G > 65535:
        raise ValueError(f"T={T} or G={G} is beyond the grid")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    out = x.dtype if mode == "pallas" else torch.float32
    y = torch.empty((T, q, R, p), dtype=out, device=dev)
    S = torch.empty((T, R, n, p), dtype=out, device=dev)
    kern = kernel_for(
        x.dtype, mode, q, n, p,
        [t.stride(d) for t in (x, B, C, y, S) for d in (0, 1, 2)],
        [t.data_ptr() % 16 for t in (x, B, C, y, S)])
    if T == 0 or R == 0:
        return y, S
    strides = [t.stride(d) for t in (x, dt, dA, B, C, y) for d in (0, 1, 2)]
    strides += [S.stride(0), S.stride(1), S.stride(2)]
    args = _Args(x.data_ptr(), dt.data_ptr(), dA.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(), S.data_ptr(), *strides,
                 T, q, R, G, p, n, HEADS_PER_BLOCK[kern], MODES[mode])
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.ssd_intra_launch(args, DTYPES[x.dtype], KERNELS[kern],
                                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_intra kernel launch failed ({kern}): CUDA error {err} "
            f"({lib.ssd_intra_error_string(err).decode()})")
    LAUNCHES += 1
    LAUNCHES_BY_KERNEL[kern] += 1
    return y, S


class _SsdIntra(torch.autograd.Function):
    """The kernel as the forward; the backward is the VJP of
    ``ref.ssd_intra_plain`` in the same ``mode``, recomputed from the
    saved inputs (the reference's Pallas kernel has no VJP)."""

    @staticmethod
    def forward(ctx, x, dt, dA, B, C, mode):
        ctx.save_for_backward(x, dt, dA, B, C)
        ctx.mode = mode
        return launch(x, dt, dA, B, C, mode=mode)

    @staticmethod
    def backward(ctx, dy, dS):
        return ref.vjp(ref.ssd_intra_plain, ctx.saved_tensors,
                       ctx.needs_input_grad[:5], (dy, dS),
                       mode=ctx.mode) + (None,)


def ssd_intra(x, dt, dA, B, C, *, mode: str = "pallas"):
    """x [T,q,R,p]; dt, dA [T,q,R] float32; B, C [T,q,G,n] with head h
    reading group h // (R // G).  Returns (y [T,q,R,p], S [T,R,n,p]).

    On the card this launches the CUDA kernel ``kernel_for`` picks, under
    autograd through ``_SsdIntra`` (the kernel forward, the plain
    version's VJP backward); on the CPU it runs ``ref.ssd_intra_plain``,
    which autograd differentiates."""
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, dt, dA, B, C)):
            return _SsdIntra.apply(x, dt, dA, B, C, mode)
        return launch(x, dt, dA, B, C, mode=mode)
    if x.device.type == "cpu":
        check(x, dt, dA, B, C, mode)
        return ref.ssd_intra_plain(x, dt, dA, B, C, mode=mode)
    raise ValueError(f"no ssd_intra path for device {x.device}")
