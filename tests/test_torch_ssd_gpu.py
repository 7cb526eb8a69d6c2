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
1e-4 in float32, 5e-2 in bf16.
"""
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
    y, S = ssd_scan.ssd_intra(x, dt, dA, B, C, mode=mode)
    assert ssd_scan.LAUNCHES == launches + 1
    want_y, want_S = ref.ssd_intra_plain(x, dt, dA, B, C, mode=mode)
    assert y.dtype == want_y.dtype and S.dtype == want_S.dtype
    assert_close(y, want_y, TOL[dtype])
    assert_close(S, want_S, TOL[dtype])


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
