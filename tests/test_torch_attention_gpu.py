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


# (B, H, K, hd, page, nb, P, lens): lens None draws them in [1, nb*page)
PAGED_CASES = [
    (2, 4, 2, 64, 64, 4, 16, None), (1, 8, 1, 32, 32, 8, 16, None),
    (4, 4, 4, 16, 16, 2, 32, None), (8, 32, 8, 64, 128, 8, 64, None),
    (2, 14, 2, 128, 64, 4, 16, None),    # hd 128, G 7 (qwen2-vl-7b)
    (2, 16, 2, 128, 64, 4, 16, None),    # hd 128, G 8
    (4, 10, 1, 256, 64, 8, 32, None),    # hd 256, G 10 (recurrentgemma-2b)
    # 16 CTAs a cluster: lens 1 and 65 leave 15 and 14 of them empty
    (4, 8, 2, 64, 64, 16, 64, (1, 65, 130, 1000)),
    (2, 8, 2, 64, 64, 4, 8, (256, 256)),  # lens == nb * page
    # qwen3-32b's decode geometry: 8 x 4096 tokens, hd 128, G 8
    (8, 64, 8, 128, 128, 32, 256, (4096,) * 8),
]


@pytest.mark.parametrize("B,H,K,hd,page,nb,P,lens", PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_matches_plain(cuda, B, H, K, hd, page, nb, P, lens,
                                    dtype):
    rng = np.random.default_rng(2)
    q = draw((B, H, hd), dtype, cuda, rng)
    kp = draw((P, page, K, hd), dtype, cuda, rng)
    vp = draw((P, page, K, hd), dtype, cuda, rng)
    tables = torch.from_numpy(rng.permutation(P)[:B * nb].reshape(B, nb)
                              .astype(np.int32)).to(cuda)
    if lens is None:
        lens = rng.integers(1, nb * page, size=B)
    lens = torch.from_numpy(np.asarray(lens, np.int32)).to(cuda)
    n, by = pa.LAUNCHES, dict(pa.LAUNCHES_BY_FORM)
    got = ops.paged_attention(q, kp, vp, tables, lens)
    assert pa.LAUNCHES == n + 1
    by["cluster" if pa.plan(B, K, nb, page, hd, H // K).clustered
       else "two_pass"] += 1
    assert pa.LAUNCHES_BY_FORM == by
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
    q48 = torch.zeros(2, 4, 48, device=cuda)
    pages48 = torch.zeros(4, 8, 2, 48, device=cuda)
    tables = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    n = pa.LAUNCHES
    with pytest.raises(ValueError, match="head widths"):
        pa.paged_attention(q48, pages48, pages48, tables, lens)
    q17 = torch.zeros(2, 34, 16, device=cuda)
    with pytest.raises(ValueError, match="query heads per kv head"):
        pa.paged_attention(q17, pages, pages, tables, lens)
    assert pa.LAUNCHES == n


def test_paged_kernel_zero_length_gives_zeros(cuda):
    """lens[b] = 0 gives zeros, as the Pallas body does (no page of the
    request is live); the other request is unaffected."""
    rng = np.random.default_rng(3)
    q = draw((2, 8, 64), "bfloat16", cuda, rng)
    kp, vp = (draw((8, 64, 2, 64), "bfloat16", cuda, rng) for _ in range(2))
    tables = torch.arange(8, dtype=torch.int32, device=cuda).reshape(2, 4)
    lens = torch.tensor([0, 100], dtype=torch.int32, device=cuda)
    got = pa.paged_attention(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert bool((got[0] == 0).all())
    assert_close(got[1:], ref.paged_attention_reference(
        q[1:], kp, vp, tables[1:], lens[1:]), 3e-2)


@pytest.mark.parametrize("B,H,K,hd,page,nb,P,lens", [
    c for c in PAGED_CASES if c[3] in (64, 128, 256)])
@pytest.mark.parametrize("clustered", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_forms_match_plain(cuda, B, H, K, hd, page, nb, P, lens,
                                 clustered, dtype):
    """Each form of the merge, forced where the plan picks the other (the
    comparison chip_smoke.py phase 8 times), computes the same function
    and is counted under its own name."""
    rng = np.random.default_rng(4)
    q = draw((B, H, hd), dtype, cuda, rng)
    kp, vp = (draw((P, page, K, hd), dtype, cuda, rng) for _ in range(2))
    tables = torch.from_numpy(rng.permutation(P)[:B * nb].reshape(B, nb)
                              .astype(np.int32)).to(cuda)
    if lens is None:
        lens = rng.integers(1, nb * page, size=B)
    lens = torch.from_numpy(np.asarray(lens, np.int32)).to(cuda)
    by = dict(pa.LAUNCHES_BY_FORM)
    got = pa.launch(q, kp, vp, tables, lens, clustered=clustered)
    by["cluster" if clustered else "two_pass"] += 1
    assert pa.LAUNCHES_BY_FORM == by
    assert_close(got, ref.paged_attention_reference(q, kp, vp, tables, lens),
                 1e-5 if dtype == "float32" else 3e-2)


def test_paged_cluster_slots_hold_on_the_card(cuda):
    """The card holds at least as many clusters of each size at once as
    the planner's table assumes (else a planned launch runs in waves)."""
    for hd in (64, 128):
        card = pa.clusters_on_card(hd)
        assert all(card[s] >= n for s, n in pa.CLUSTER_SLOTS.items()), card
