"""The attention CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs the card: it skips elsewhere with a reason, and
runs on a machine with one through (jax is not needed there, hence
``--noconftest``)

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_attention_gpu.py

Inputs are numpy draws from a seed, on the card; the kernel (the
wrapper's path for CUDA tensors) and the plain version (``kernels.ref``)
see the same tensors.  Tolerances are the JAX kernel tests' own: float32
1e-5; bfloat16 2e-2 for flash and 3e-2 for paged attention.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m gpu on a machine "
                    "that has one")
    return torch.device("cuda")


def draw(shape, dtype, dev, rng):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(dev).to(DTYPES[dtype])


def assert_close(got, want, tol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,S,H,K,hd", [
    (1, 128, 2, 2, 32), (2, 256, 4, 2, 64), (1, 256, 8, 1, 64),
    (2, 128, 6, 3, 16), (2, 77, 4, 2, 16), (8, 512, 32, 8, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, B, S, H, K, hd, dtype, causal):
    rng = np.random.default_rng(0)
    q, k, v = (draw(s, dtype, cuda, rng) for s in
               ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    n = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal)
    assert fa.LAUNCHES == n + 1
    want = ref.mha_reference(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal).transpose(1, 2)
    assert_close(got, want, 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_kernel_windowed(cuda, window):
    rng = np.random.default_rng(1)
    q, k, v = (draw(s, "float32", cuda, rng) for s in
               ((1, 4, 256, 32), (1, 2, 256, 32), (1, 2, 256, 32)))
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = ref.mha_reference(q, k, v, causal=True, window=window)
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("B,H,K,hd,page,nb,P", [
    (2, 4, 2, 64, 64, 4, 16), (1, 8, 1, 32, 32, 8, 16),
    (4, 4, 4, 16, 16, 2, 32), (8, 32, 8, 64, 128, 8, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_matches_plain(cuda, B, H, K, hd, page, nb, P, dtype):
    rng = np.random.default_rng(2)
    q = draw((B, H, hd), dtype, cuda, rng)
    kp = draw((P, page, K, hd), dtype, cuda, rng)
    vp = draw((P, page, K, hd), dtype, cuda, rng)
    tables = torch.from_numpy(rng.permutation(P)[:B * nb].reshape(B, nb)
                              .astype(np.int32)).to(cuda)
    lens = torch.from_numpy(rng.integers(1, nb * page, size=B)
                            .astype(np.int32)).to(cuda)
    n = pa.LAUNCHES
    got = ops.paged_attention(q, kp, vp, tables, lens)
    assert pa.LAUNCHES == n + 1
    want = ref.paged_attention_reference(q, kp, vp, tables, lens)
    assert_close(got, want, 1e-5 if dtype == "float32" else 3e-2)


def test_kernels_refuse_on_the_card(cuda):
    q = torch.zeros(1, 4, 8, 128, device=cuda)
    with pytest.raises(ValueError, match="head widths"):
        fa.flash_attention(q, q[:, :2], q[:, :2])
    qd = torch.zeros(2, 4, 16, device=cuda)
    pages = torch.zeros(4, 8, 2, 16, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(qd, pages, pages,
                           torch.zeros(2, 2, dtype=torch.int64, device=cuda),
                           torch.ones(2, dtype=torch.int32, device=cuda))
