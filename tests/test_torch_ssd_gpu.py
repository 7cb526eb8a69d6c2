"""The ssd_intra CUDA kernel against its plain PyTorch version, on the card.

Every test here needs the card: it skips elsewhere with a reason, and
runs on a machine with one through (jax is not needed there, hence
``--noconftest``)

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_ssd_gpu.py

Inputs are numpy draws from a seed, on the card; the kernel (the
wrapper's path for CUDA tensors) and the plain version
(``ref.ssd_intra_plain``) see the same tensors, in both roundings.
Tolerances are the JAX kernel test's own (``tests/test_kernels_ssd.py``):
1e-4 in float32, 5e-2 in bf16.  Each call is checked to have run the
kernel of its route: bf16 in ``model`` rounding with n and p multiples
of 8 on the tensor cores (``mma_bf16``), everything else on the CUDA
cores (``fma_f32``).
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# (T, q, G, r, p, n): tests/test_kernels_ssd.py's shapes (B and C per
# head), mamba2-2.7b's smoke shape, a ragged one, its full prefill's
SHAPES = [(2, 32, 4, 1, 16, 16), (1, 64, 2, 1, 32, 32), (3, 16, 8, 1, 8, 16),
          (8, 8, 1, 8, 16, 16), (2, 40, 2, 5, 20, 36),
          (32, 128, 1, 80, 64, 128)]
# (T, q, G, r, p, n) the mma_bf16 route takes at its edges: heads that
# are no multiple of its 10 a block, G > 1, q below 128 and off the
# 16-token tiles, n and p below the tiles
MMA_SHAPES = [(3, 128, 2, 13, 64, 128), (2, 48, 3, 4, 32, 64),
              (2, 100, 2, 3, 24, 40), (4, 8, 1, 8, 16, 16)]


def route(dtype, mode, n, p):
    """The kernel a call should run (the rule ``kernel_for`` documents)."""
    if dtype == "bfloat16" and mode == "model" and n % 8 == 0 \
            and p % 8 == 0:
        return "mma_bf16"
    return "fma_f32"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m gpu on a machine "
                    "that has one")
    return torch.device("cuda")


def inputs(T, q, G, r, p, n, dtype, dev, seed=0):
    """The model's layout: x, B and C slices of one [T*q, conv_dim]
    buffer (x's token stride is conv_dim), dt and dA float32 with
    Mamba-2's ranges (decays pass the clip at -60)."""
    rng = np.random.default_rng(seed)
    R = G * r
    conv = rng.standard_normal((T * q, R * p + 2 * G * n), dtype=np.float32)
    xbc = torch.from_numpy(conv).to(dev).to(DTYPES[dtype])
    x = xbc[:, :R * p].view(T, q, R, p)
    B = xbc[:, R * p:R * p + G * n].view(T, q, G, n)
    C = xbc[:, R * p + G * n:].view(T, q, G, n)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (T, q, R))) \
        * rng.uniform(0.5, 20.0, (1, 1, R))
    A = -rng.uniform(1.0, 16.0, R)
    dt_d = torch.from_numpy(dt.astype(np.float32)).to(dev)
    dA_d = torch.from_numpy((dt * A).astype(np.float32)).to(dev)
    return x, dt_d, dA_d, B, C


def assert_close(got, want, tol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("T,q,G,r,p,n", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["pallas", "model"])
def test_ssd_kernel_matches_plain(cuda, T, q, G, r, p, n, dtype, mode):
    x, dt, dA, B, C = inputs(T, q, G, r, p, n, dtype, cuda)
    launches = ssd_scan.LAUNCHES
    by_kernel = dict(ssd_scan.LAUNCHES_BY_KERNEL)
    y, S = ssd_scan.ssd_intra(x, dt, dA, B, C, mode=mode)
    assert ssd_scan.LAUNCHES == launches + 1
    kern = route(dtype, mode, n, p)
    assert ssd_scan.LAUNCHES_BY_KERNEL[kern] == by_kernel[kern] + 1
    want_y, want_S = ref.ssd_intra_plain(x, dt, dA, B, C, mode=mode)
    assert y.dtype == want_y.dtype and S.dtype == want_S.dtype
    assert_close(y, want_y, TOL[dtype])
    assert_close(S, want_S, TOL[dtype])


@pytest.mark.parametrize("T,q,G,r,p,n", MMA_SHAPES)
def test_mma_route_at_its_edges(cuda, T, q, G, r, p, n):
    x, dt, dA, B, C = inputs(T, q, G, r, p, n, "bfloat16", cuda, seed=1)
    mma = ssd_scan.LAUNCHES_BY_KERNEL["mma_bf16"]
    y, S = ssd_scan.ssd_intra(x, dt, dA, B, C, mode="model")
    assert ssd_scan.LAUNCHES_BY_KERNEL["mma_bf16"] == mma + 1
    want_y, want_S = ref.ssd_intra_plain(x, dt, dA, B, C, mode="model")
    assert_close(y, want_y, TOL["bfloat16"])
    assert_close(S, want_S, TOL["bfloat16"])


def test_launches_by_kernel_count_each_route(cuda):
    before = dict(ssd_scan.LAUNCHES_BY_KERNEL)
    for dtype in ("float32", "bfloat16"):
        x, dt, dA, B, C = inputs(2, 64, 1, 4, 64, 128, dtype, cuda)
        for mode in ("pallas", "model"):
            ssd_scan.ssd_intra(x, dt, dA, B, C, mode=mode)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in ssd_scan.LAUNCHES_BY_KERNEL.items()}
    assert got == {"mma_bf16": 1, "fma_f32": 3}


def test_mma_route_refuses_unaligned_operands(cuda):
    """An unaligned pointer or token stride raises before any launch (no
    call passes to the FMA kernel), and the C launch refuses one too."""
    T, q, G, r, p, n = 2, 64, 1, 4, 64, 128
    R = G * r
    buf = torch.randn(T * q, R * p + 2 * G * n + 8, device=cuda).bfloat16()
    launches = dict(ssd_scan.LAUNCHES_BY_KERNEL)
    _, dt, dA, _, _ = inputs(T, q, G, r, p, n, "bfloat16", cuda)
    off = buf[:, 1:1 + R * p + 2 * G * n]          # pointers 2 bytes off
    x = off[:, :R * p].view(T, q, R, p)
    B = off[:, R * p:R * p + G * n].view(T, q, G, n)
    C = off[:, R * p + G * n:].view(T, q, G, n)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd_scan.ssd_intra(x, dt, dA, B, C, mode="model")
    odd = torch.randn(T * q, R * p + 2 * G * n + 1, device=cuda).bfloat16()
    x = odd[:, :R * p].view(T, q, R, p)              # token stride odd
    B = odd[:, R * p:R * p + G * n].view(T, q, G, n)
    C = odd[:, R * p + G * n:R * p + 2 * G * n].view(T, q, G, n)
    with pytest.raises(ValueError, match="16-byte units"):
        ssd_scan.ssd_intra(x, dt, dA, B, C, mode="model")
    assert ssd_scan.LAUNCHES_BY_KERNEL == launches

    x, dt, dA, B, C = inputs(T, q, G, r, p, n, "bfloat16", cuda)
    y = torch.empty((T, q, R, p), device=cuda)
    S = torch.empty((T, R, n, p), device=cuda)
    strides = [t.stride(d) for t in (x, dt, dA, B, C, y) for d in (0, 1, 2)]
    strides += [S.stride(d) for d in (0, 1, 2)]
    args = ssd_scan._Args(x.data_ptr() + 2, dt.data_ptr(), dA.data_ptr(),
                          B.data_ptr(), C.data_ptr(), y.data_ptr(),
                          S.data_ptr(), *strides, T, q, R, G, p, n,
                          ssd_scan.HEADS_PER_BLOCK["mma_bf16"],
                          ssd_scan.MODES["model"])
    lib = ssd_scan._lib()
    err = lib.ssd_intra_launch(args, ssd_scan.DTYPES[torch.bfloat16],
                               ssd_scan.KERNELS["mma_bf16"],
                               ctypes.c_void_p(
                                   torch.cuda.current_stream().cuda_stream))
    assert err != 0
    assert "misaligned" in lib.ssd_intra_error_string(err).decode()


def test_ssd_kernel_refuses_on_the_card(cuda):
    x, dt, dA, B, C = inputs(1, 256, 1, 2, 64, 128, "float32", cuda)
    with pytest.raises(ValueError, match="q <= 128"):
        ssd_scan.ssd_intra(x, dt, dA, B, C)
    x, dt, dA, B, C = inputs(1, 128, 1, 2, 64, 128, "float32", cuda)
    xt = torch.zeros(1, 128, 64, 2, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan.ssd_intra(xt, dt, dA, B, C)
    with pytest.raises(TypeError, match="takes"):
        ssd_scan.ssd_intra(x.half(), dt, dA, B.half(), C.half())
