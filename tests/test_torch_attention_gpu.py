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
1e-5; bfloat16 2e-2 for flash and 3e-2 for paged attention.  Every bf16
flash call must run on the tensor-core kernel (``mma_bf16``) and every
float32 call on the CUDA-core kernel (``fma_f32``): the tests count
``LAUNCHES_BY_KERNEL``.
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
FLASH_KERNEL = {"float32": "fma_f32", "bfloat16": "mma_bf16"}


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
    n, by = fa.LAUNCHES, dict(fa.LAUNCHES_BY_KERNEL)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert fa.LAUNCHES == n + 1
    by[FLASH_KERNEL[dtype]] += 1
    assert fa.LAUNCHES_BY_KERNEL == by
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


def mma_matches_plain(q, k, v, *, causal, window=None, model_layout=False):
    """One bf16 call through the wrapper ([B,S,H,hd] views through ops
    where ``model_layout``), counted on mma_bf16, against the plain
    version within the JAX test's bf16 tolerance."""
    n = fa.LAUNCHES_BY_KERNEL["mma_bf16"]
    if model_layout:
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        q, k, v, got = (x.transpose(1, 2) for x in (q, k, v, got))
    else:
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES_BY_KERNEL["mma_bf16"] == n + 1
    assert_close(got, ref.mha_reference(q, k, v, causal=causal,
                                        window=window), 2e-2)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_mma_windowed(cuda, window):
    rng = np.random.default_rng(1)
    q, k, v = (draw(s, "bfloat16", cuda, rng) for s in
               ((1, 4, 256, 32), (1, 2, 256, 32), (1, 2, 256, 32)))
    mma_matches_plain(q, k, v, causal=True, window=window)


@pytest.mark.parametrize("S,Sk", [(77, 200), (200, 77), (77, 77)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_mma_ragged(cuda, S, Sk, causal):
    """Lengths that are no multiple of a 64-row tile, Sk != S."""
    rng = np.random.default_rng(3)
    q, k, v = (draw(s, "bfloat16", cuda, rng) for s in
               ((2, 4, S, 64), (2, 2, Sk, 64), (2, 2, Sk, 64)))
    mma_matches_plain(q, k, v, causal=causal)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_mma_hd128(cuda, causal):
    rng = np.random.default_rng(4)
    q, k, v = (draw(s, "bfloat16", cuda, rng) for s in
               ((2, 8, 320, 128), (2, 2, 320, 128), (2, 2, 320, 128)))
    mma_matches_plain(q, k, v, causal=causal)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_mma_model_layout(cuda, hd):
    """The model's [B,S,H,hd] tensors, seen as strided [B,H,S,hd]."""
    rng = np.random.default_rng(5)
    q, k, v = (draw(s, "bfloat16", cuda, rng) for s in
               ((2, 200, 8, hd), (2, 200, 4, hd), (2, 200, 4, hd)))
    mma_matches_plain(q, k, v, causal=True, model_layout=True)


def test_flash_mma_refuses_misaligned_views(cuda):
    """A bf16 call the tensor-core kernel cannot take raises and launches
    nothing: it never passes to the float32 kernel."""
    base = torch.zeros(1 * 2 * 64 * 64 + 8, dtype=torch.bfloat16,
                       device=cuda)
    q = base[1:1 + 2 * 64 * 64].view(1, 2, 64, 64)   # 2 bytes off
    kv = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16, device=cuda)
    odd = torch.zeros(1, 2, 64, 66, dtype=torch.bfloat16,
                      device=cuda)[..., :64]           # s stride 66
    n, by = fa.LAUNCHES, dict(fa.LAUNCHES_BY_KERNEL)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.flash_attention(odd, kv, kv)
    assert fa.LAUNCHES == n and fa.LAUNCHES_BY_KERNEL == by


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
