"""Forward flash attention with GQA, causal and sliding-window masks, as
CUDA kernels written by hand for Hopper (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:85``
(``flash_attention``; body ``_kernel`` at :26).  The prefill attention of
the port's transformer runs through it, one launch per layer, and so
does the training forward (``_Flash``: the kernel forward, the plain
version's VJP backward).

``flash_attention`` picks the path from the device of the tensors it is
given: on CUDA tensors it launches a kernel (or raises); on CPU tensors
it runs the plain PyTorch version, ``ref.mha_reference``.  No flag or
environment variable chooses the path.  On the card ``kernel_for``
picks the kernel from the dtype, both on the tensor cores and both for
hd 16 to 256: bf16 runs ``flash_mma`` (``mma_bf16``), float32
``flash_tf32x3`` (``mma_tf32x3``), which splits each float32 operand
into two TF32 halves and sums three TF32 products, hi.hi + hi.lo +
lo.hi, so that it meets the 1e-5 tolerance one TF32 pass cannot.  Both
copy rows in 16-byte pieces (cp.async), so they need 16-byte aligned
data pointers and b, h and s strides in whole 16-byte units.  A call
that the dtype's kernel cannot take raises (a head width of 48, say, or
a misaligned view); none passes to the other kernel or to the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# kernel launches made by flash_attention since import, in all and by
# kernel (training counts its forward's and remat's recomputation's)
LAUNCHES = 0
LAUNCHES_BY_KERNEL = {"mma_bf16": 0, "mma_tf32x3": 0}

# dtype -> (kernel, the C side's dtype code, head widths it is built for)
KERNELS = {torch.bfloat16: ("mma_bf16", 1, (16, 32, 64, 128, 256)),
           torch.float32: ("mma_tf32x3", 0, (16, 32, 64, 128, 256))}

_p, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int32


class _Args(ctypes.Structure):
    _fields_ = ([(n, _p) for n in ("q", "k", "v", "o")]
                + [(f"{t}_s{d}", _ll) for t in "qkvo" for d in "bhs"]
                + [(n, _i) for n in ("B", "H", "K", "S", "Sk", "causal",
                                     "window")]
                + [("scale", ctypes.c_float)])


_LIB = None


def _lib() -> ctypes.CDLL:
    """The compiled kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = build.load("flash_attention")
        lib.flash_attention_args_size.restype = ctypes.c_int
        lib.flash_attention_launch.argtypes = [_Args, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int,
                                                   ctypes.c_int]
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
        lib.flash_attention_blocks_per_sm.argtypes = [ctypes.c_int,
                                                      ctypes.c_int]
        lib.flash_attention_blocks_per_sm.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        got = lib.flash_attention_args_size()
        if got != ctypes.sizeof(_Args):
            raise RuntimeError(f"FlashArgs is {got} bytes in C, "
                               f"{ctypes.sizeof(_Args)} in ctypes")
        _LIB = lib
    return _LIB


def check(q, k, v, window):
    """Shapes the function takes (both paths): (B, H, S, K, Sk, hd)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D: q [B,H,S,hd], "
                         "k/v [B,K,Sk,hd]")
    B, H, S, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B \
            or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit together")
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} kv "
                         f"heads")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    return B, H, S, K, Sk, hd


def kernel_for(dtype, hd, strides, ptr_mod16) -> str:
    """The kernel that takes a call: ``"mma_bf16"`` or ``"mma_tf32x3"``;
    raises when the dtype's kernel cannot take it.

    ``strides`` are the b, h and s strides (in elements) of q, k, v and
    o; ``ptr_mod16`` their data pointers modulo 16.  Both kernels copy
    rows in 16-byte pieces (cp.async), so they need both in whole 16-byte
    units: strides that are multiples of 8 bf16 or 4 float32 elements."""
    if dtype not in KERNELS:
        raise TypeError(f"the kernels take {list(KERNELS)}, not {dtype}")
    name, _, dims = KERNELS[dtype]
    if hd not in dims:
        raise ValueError(f"the {name} kernel takes head widths {dims}, not "
                         f"{hd}")
    per16 = 16 // dtype.itemsize
    odd = [s for s in strides if s % per16]
    if odd:
        raise ValueError(f"the {name} kernel needs b, h and s strides that "
                         f"are multiples of {per16} elements, got {odd}")
    if any(ptr_mod16):
        raise ValueError(f"the {name} kernel needs 16-byte aligned data "
                         f"pointers, got offsets {list(ptr_mod16)} modulo 16")
    return name


def smem_bytes(dtype, hd) -> int:
    """Shared memory one launch of the kernel for (dtype, hd) uses, as
    the compiled library reports it (builds it at first use)."""
    return _lib().flash_attention_smem_bytes(KERNELS[dtype][1], hd)


def blocks_per_sm(dtype, hd) -> int:
    """Blocks of the kernel for (dtype, hd) an SM of the current device
    holds at once, as the occupancy calculator gives them (registers,
    shared memory, threads); needs the card."""
    n = _lib().flash_attention_blocks_per_sm(KERNELS[dtype][1], hd)
    if n < 0:
        raise RuntimeError(f"no occupancy for the {dtype} kernel at hd {hd}")
    return n


def launch(q, k, v, *, causal=True, window=None):
    """The CUDA kernel on CUDA tensors; raises on anything it does not
    take, and when the launch is refused.  Returns [B,H,S,hd] in q's
    dtype (a [B,S,H,hd]-contiguous tensor viewed as [B,H,S,hd], so that
    the model's layout swap back costs no copy)."""
    global LAUNCHES
    B, H, S, K, Sk, hd = check(q, k, v, window)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash_attention kernel runs on CUDA tensors, "
                         f"q is on {dev}")
    for name, x in (("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
    if max(H, B) > 65535:
        raise ValueError(f"B={B} and H={H} must be at most 65535")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous")
    o = torch.empty((B, S, H, hd), dtype=q.dtype,
                    device=dev).transpose(1, 2)
    strides = [x.stride(d) for x in (q, k, v, o) for d in (0, 1, 2)]
    kern = kernel_for(q.dtype, hd, strides,
                      [x.data_ptr() % 16 for x in (q, k, v, o)])
    if o.numel() == 0:
        return o
    args = _Args(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 *strides, B, H, K, S, Sk, int(bool(causal)),
                 0 if window is None else int(window), 1.0 / (hd ** 0.5))
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            args, KERNELS[q.dtype][1], hd,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} "
            f"({lib.flash_attention_error_string(err).decode()})")
    LAUNCHES += 1
    LAUNCHES_BY_KERNEL[kern] += 1
    return o


class _Flash(torch.autograd.Function):
    """The kernel as the forward; the backward is the VJP of
    ``ref.mha_reference`` recomputed from the saved q, k and v (the
    reference's Pallas kernel has no VJP, and its models train through
    plain JAX)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return launch(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        return ref.vjp(ref.mha_reference, ctx.saved_tensors,
                       ctx.needs_input_grad[:3], (do,), causal=ctx.causal,
                       window=ctx.window) + (None, None)


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q [B,H,S,hd]; k,v [B,K,Sk,hd] with H % K == 0. Returns [B,H,S,hd].

    On the card this launches the dtype's CUDA kernel, under autograd
    through ``_Flash`` (which keeps q, k and v for the backward; a
    ``remat`` layer launches it again there); on the CPU it runs
    ``ref.mha_reference``, which autograd differentiates."""
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _Flash.apply(q, k, v, causal, window)
        return launch(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        check(q, k, v, window)
        return ref.mha_reference(q, k, v, causal=causal, window=window)
    raise ValueError(f"no flash_attention path for device {q.device}")
