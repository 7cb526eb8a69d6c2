"""The port's attention functions against the JAX package's.

Inputs are drawn with numpy from a seed and fed to both sides.  The JAX
side runs as its own tests run it: ``repro.kernels.ops`` (the Pallas
kernels, in interpret mode on the CPU) and the ``repro.kernels.ref``
oracles.  The port's side is what its wrappers run on CPU tensors: the
plain PyTorch versions, against which ``chip_smoke.py`` and
``tests/test_torch_attention_gpu.py`` hold the CUDA kernels on the card.

Tolerances are the JAX kernel tests' own: float32 1e-5; bfloat16 2e-2
for flash and 3e-2 for paged attention (atol and rtol alike).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref

TOL_F32 = 1e-5
TOL_FLASH_BF16 = 2e-2
TOL_PAGED_BF16 = 3e-2

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(a: np.ndarray, dtype: str):
    """The same float32 numpy draw as a JAX array and a torch tensor, both
    rounded to ``dtype`` the same way (round to nearest even)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


def flash_inputs(B, S, H, K, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [both(rng.standard_normal(shape, dtype=np.float32), dtype)
            for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd))]


@pytest.mark.parametrize("B,S,H,K,hd", [
    (1, 128, 2, 2, 32),   # MHA
    (1, 256, 8, 1, 64),   # MQA
    (2, 128, 6, 3, 16),   # odd group
    (1, 128, 8, 2, 128),  # hd 128, G 4 (the dense configs' width)
    (1, 128, 10, 1, 256),  # hd 256, G 10 on one kv head (recurrentgemma)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax(B, S, H, K, hd, dtype, causal):
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(B, S, H, K, hd, dtype)
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (B, S, H, hd) and got.dtype == tq.dtype
    tol = TOL_F32 if dtype == "float32" else TOL_FLASH_BF16
    assert_close(got, jops.flash_attention(jq, jk, jv, causal=causal), tol)
    want = jref.mha_reference(jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
                              jnp.swapaxes(jv, 1, 2), causal=causal)
    assert_close(got, jnp.swapaxes(want, 1, 2), tol)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_plain_windowed_matches_jax(window):
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(1, 256, 4, 2, 32, "float32")
    got = tops.flash_attention(tq, tk, tv, causal=True, window=window)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                block_q=64, block_k=64)
    assert_close(got, want, TOL_F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_hd256_window_binds(dtype):
    """recurrentgemma-2b's local attention at its head width, 10 query
    heads on one kv head, over 256 positions under a window of 64 that
    binds (the full model's window, 2048, binds only past 2048 tokens)."""
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(1, 256, 10, 1, 256, dtype, 5)
    got = tops.flash_attention(tq, tk, tv, causal=True, window=64)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=64,
                                block_q=64, block_k=64)
    assert_close(got, want, TOL_F32 if dtype == "float32" else TOL_FLASH_BF16)


@pytest.mark.parametrize("S", [1, 77, 200])
def test_flash_plain_ragged_matches_ref(S):
    """Lengths that are no multiple of a tile (the Pallas wrapper asserts
    divisibility, so the oracle alone is the reference here)."""
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(2, S, 4, 2, 16, "float32", 3)
    got = tfa.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), causal=True, window=50)
    want = jref.mha_reference(jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
                              jnp.swapaxes(jv, 1, 2), causal=True, window=50)
    assert_close(got, want, TOL_F32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_rows_that_see_no_key_are_zero(causal):
    """S > Sk - 1 + window leaves rows Sk - 1 + window .. S - 1 no key.
    The plain version gives 0 there, as the Pallas kernel does when it
    skips every k-block of such a row: with one query row a block, no row
    that sees no key shares a block with one that does, and the rest of
    the rows are exact."""
    rng = np.random.default_rng(7)
    B, S, Sk, H, K, hd, window = 1, 40, 12, 2, 1, 16, 8
    (jq, tq), (jk, tk), (jv, tv) = (
        both(rng.standard_normal(shape, dtype=np.float32), "float32")
        for shape in ((B, S, H, hd), (B, Sk, K, hd), (B, Sk, K, hd)))
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                block_q=1, block_k=4)
    assert_close(got, want, TOL_F32)
    blind = Sk - 1 + window
    assert not got[:, blind:].any()
    assert got[:, :blind].abs().sum(-1).min() > 0


def paged_inputs(B, H, K, hd, page, nb, P, dtype, seed=1):
    rng = np.random.default_rng(seed)
    q = both(rng.standard_normal((B, H, hd), dtype=np.float32), dtype)
    kp = both(rng.standard_normal((P, page, K, hd), dtype=np.float32), dtype)
    vp = both(rng.standard_normal((P, page, K, hd), dtype=np.float32), dtype)
    tables = rng.permutation(P)[:B * nb].reshape(B, nb).astype(np.int32)
    lens = rng.integers(1, nb * page, size=B).astype(np.int32)
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("B,H,K,hd,page,nb,P", [
    (2, 4, 2, 64, 64, 4, 16),
    (1, 8, 1, 32, 32, 8, 16),   # MQA
    (4, 4, 4, 16, 16, 2, 32),   # MHA
    (2, 14, 2, 128, 16, 4, 16),  # hd 128, G 7 (qwen2-vl-7b's grouping)
    (2, 10, 1, 256, 16, 4, 8),   # hd 256, G 10 on one kv head (recurrentgemma)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_jax(B, H, K, hd, page, nb, P, dtype):
    """A permuted pool and ragged context lengths."""
    (jq, tq), (jk, tk), (jv, tv), tables, lens = paged_inputs(
        B, H, K, hd, page, nb, P, dtype)
    got = tops.paged_attention(tq, tk, tv, torch.from_numpy(tables),
                               torch.from_numpy(lens))
    assert got.shape == (B, H, hd) and got.dtype == tq.dtype
    tol = TOL_F32 if dtype == "float32" else TOL_PAGED_BF16
    jt, jl = jnp.asarray(tables), jnp.asarray(lens)
    assert_close(got, jops.paged_attention(jq, jk, jv, jt, jl), tol)
    assert_close(got, jref.paged_attention_reference(jq, jk, jv, jt, jl), tol)


def test_paged_plain_permutation_invariance():
    """Where the pages lie in the pool does not change the result."""
    B, H, K, hd, page, nb, P = 2, 4, 2, 32, 32, 4, 32
    (_, q), (_, kp), (_, vp), _, _ = paged_inputs(B, H, K, hd, page, nb, P,
                                                  "float32", seed=2)
    tables = torch.arange(B * nb, dtype=torch.int32).reshape(B, nb)
    lens = torch.full((B,), nb * page, dtype=torch.int32)
    o1 = tops.paged_attention(q, kp, vp, tables, lens)
    perm = torch.from_numpy(np.random.default_rng(5).permutation(P))
    inv = torch.argsort(perm)
    o2 = tops.paged_attention(q, kp[inv], vp[inv],
                              perm[tables.long()].to(torch.int32), lens)
    assert_close(o1, o2, TOL_F32)


def test_paged_over_contiguous_cache_is_masked_attention():
    """The decode view: a [B,S,K,hd] cache as pages with the identity
    table equals attention over the first lens positions."""
    B, S, K, G, hd, page = 2, 64, 2, 3, 16, 16
    rng = np.random.default_rng(4)
    cache_k = torch.from_numpy(rng.standard_normal((B, S, K, hd),
                                                   dtype=np.float32))
    cache_v = torch.from_numpy(rng.standard_normal((B, S, K, hd),
                                                   dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((B, K * G, hd),
                                             dtype=np.float32))
    lens = torch.tensor([5, 64], dtype=torch.int32)
    nb = S // page
    tables = torch.arange(B * nb, dtype=torch.int32).reshape(B, nb)
    got = tops.paged_attention(q, cache_k.view(B * nb, page, K, hd),
                               cache_v.view(B * nb, page, K, hd), tables,
                               lens)
    for b in range(B):
        n = int(lens[b])
        want = tref.mha_reference(
            q[b:b + 1, :, None], cache_k[b:b + 1, :n].transpose(1, 2),
            cache_v[b:b + 1, :n].transpose(1, 2), causal=False)[:, :, 0]
        assert_close(got[b:b + 1], want, TOL_F32)


@pytest.mark.parametrize("B,K,nb,page,hd,G,dtype,splits,smem,clustered", [
    # granite-3-2b's decode (capacity 1024): 64 pairs want 8 CTAs each,
    # but only 62 clusters of 8 fit on the card at once: clusters of 4,
    # 256 CTAs of 256 tokens of capacity each
    (8, 8, 8, 128, 64, 4, "bfloat16", 4, 50496, True),
    # qwen3-32b's decode geometry (capacity 4096): clusters of 4 would
    # leave each CTA 1024 tokens, so the two-pass form at 8, 512 CTAs
    (8, 8, 32, 128, 128, 8, "bfloat16", 8, 50496, False),
    # recurrentgemma-2b's (capacity 2048, one kv head): 8 clusters of 16
    # would be under a CTA an SM, so the two-pass form at 16, 128 CTAs
    (8, 1, 16, 128, 256, 10, "bfloat16", 16, 50496, False),
    (4, 8, 8, 128, 64, 4, "bfloat16", 8, 50496, True),   # 32 clusters of 8
    (8, 8, 64, 128, 64, 4, "bfloat16", 8, 50496, False),  # 8192 tokens
    (1, 1, 2, 16, 64, 4, "bfloat16", 1, 50496, True),    # under a chunk
    (1, 1, 5, 20, 64, 4, "bfloat16", 2, 50496, False),   # nb * page = 100
    (64, 8, 8, 128, 64, 4, "bfloat16", 1, 50496, True),  # 512 pairs
    (8, 8, 8, 128, 16, 4, "bfloat16", 4, 13632, True),   # 4 KB stages
    (8, 8, 8, 128, 64, 4, "float32", 4, 50496, True),
    (2, 2, 4, 16, 16, 3, "float32", 1, 25920, True),     # one chunk
    (2, 2, 4, 16, 256, 16, "float32", 1, 50496, True),
])
def test_paged_plan(B, K, nb, page, hd, G, dtype, splits, smem, clustered):
    """The launch plan is a function of the shapes alone: the smallest
    power of 2 of CTAs per (request, kv head) that makes two an SM (264
    CTAs on 132 SMs), at most 16 and at most the capacity's 64-token
    chunks; in the cluster form no more than keeps every cluster of the
    launch on the card at once, and that form only where its CTAs fill
    the card (one an SM) with at most 512 tokens of capacity each, or
    where a pair is one CTA; the two-pass form at the uncapped count
    elsewhere.  The shared memory is three K/V stages of at most 64 tokens
    and 16 KB, and a 1344-byte tail."""
    got = tpa.plan(B, K, nb, page, hd, G, DTYPES[dtype][1])
    assert got == (splits, smem, clustered) and got.splits == splits
    free = tpa._splits(B, K, nb, page, clustered=False)
    if B * K * free < 2 * tpa.SMS:
        assert free == tpa.MAX_SPLITS or 2 * free * tpa.CHUNK > nb * page
    if clustered:
        assert B * K <= tpa.CLUSTER_SLOTS[splits]
        assert splits == 1 or (B * K * splits >= tpa.SMS and
                               nb * page <= tpa.TWO_PASS_TOKENS * splits)
    else:
        assert splits == free


def test_paged_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="head widths"):
        tpa.plan(8, 8, 8, 128, 48, 4)
    with pytest.raises(ValueError, match="query heads per kv head"):
        tpa.plan(8, 1, 8, 128, 64, 17)
    with pytest.raises(ValueError, match="query heads per kv head"):
        tpa.plan(8, 1, 8, 128, 64, 0)
    with pytest.raises(TypeError, match="K/V"):
        tpa.plan(8, 8, 8, 128, 64, 4, torch.float16)


def cluster_emulation(q, k_pages, v_pages, tables, lens):
    """The kernel's split and merge, in float32 on the CPU: each (request,
    kv head) over plan()'s CTAs, CTA r taking chunks [r*C/S, (r+1)*C/S) of
    the C live 64-token chunks of lens[b] (clamped to nb * page), an online
    softmax in base 2 over its tokens a chunk at a time (tokens past
    lens[b] weigh 0; a CTA with none keeps m = -1e30, l = 0, acc = 0),
    then the CTAs' (m, l, acc) merged as the kernel merges them (the max M
    of the m, then l and acc weighted by 2^(m - M) and summed in rank
    order) and divided by max(l, 1e-30)."""
    B, H, hd = q.shape
    P, page, K, _ = k_pages.shape
    G, nb = H // K, tables.shape[1]
    S = tpa.plan(B, K, nb, page, hd, G, k_pages.dtype).splits
    scale2 = torch.tensor((1.0 / hd ** 0.5) * np.log2(np.e),
                          dtype=torch.float32)
    neg = torch.tensor(tref.NEG_INF, dtype=torch.float32)
    kflat = k_pages.float().reshape(P * page, K, hd)
    vflat = v_pages.float().reshape(P * page, K, hd)
    out = torch.zeros(B, H, hd)
    for b in range(B):
        n = max(0, min(int(lens[b]), nb * page))
        live = -(-n // tpa.CHUNK)
        tok = torch.arange(nb * page)
        rows = tables[b].long()[tok // page] * page + tok % page
        for kh in range(K):
            qs = q[b, kh * G:(kh + 1) * G].float()
            parts = []
            for r in range(S):
                t0 = r * live // S * tpa.CHUNK
                t1 = min((r + 1) * live // S * tpa.CHUNK, n)
                m, l, acc = neg.expand(G).clone(), torch.zeros(G), \
                    torch.zeros(G, hd)
                for c0 in range(t0, t1, tpa.CHUNK):
                    idx = rows[c0:min(c0 + tpa.CHUNK, t1)]
                    s = qs @ kflat[idx, kh].T * scale2
                    mn = torch.maximum(m, s.max(1).values)
                    corr = torch.exp2(m - mn)
                    p = torch.exp2(s - mn[:, None])
                    l = l * corr + p.sum(1)
                    acc = acc * corr[:, None] + p @ vflat[idx, kh]
                    m = mn
                parts.append((m, l, acc))
            M = torch.stack([m for m, _, _ in parts]).max(0).values
            L, A = torch.zeros(G), torch.zeros(G, hd)
            for m, l, acc in parts:
                f = torch.exp2(m - M)
                L = L + l * f
                A = A + acc * f[:, None]
            out[b, kh * G:(kh + 1) * G] = A / torch.clamp(L, min=1e-30)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("B,H,K,hd,page,nb,P,lens", [
    # 16 CTAs a cluster; lens 1 leaves 15 of them with no token, 70 14,
    # and 1024 and 2000 reach and pass nb * page
    (4, 6, 2, 16, 64, 16, 64, (1, 70, 1024, 2000)),
    # 4 CTAs over 6 chunks (shares of 1 and 2), G 16
    (2, 16, 1, 32, 32, 12, 24, (5, 384)),
    # nb * page = 100, not a multiple of 64: 2 CTAs, the second ragged
    (2, 8, 1, 64, 20, 5, 10, (100, 37)),
    # a table shorter than one chunk: 1 CTA
    (3, 4, 2, 16, 8, 4, 12, (32, 1, 17)),
])
def test_paged_split_and_merge_match_reference(B, H, K, hd, page, nb, P,
                                               lens):
    (_, q), (_, kp), (_, vp), tables, _ = paged_inputs(B, H, K, hd, page, nb,
                                                       P, "float32", seed=6)
    tables, lens = torch.from_numpy(tables), torch.tensor(lens,
                                                          dtype=torch.int32)
    want = tref.paged_attention_reference(q, kp, vp, tables, lens)
    assert_close(cluster_emulation(q, kp, vp, tables, lens), want, TOL_F32)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.launch(q, q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, q[:, :3], q[:, :3])
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, q[:, :2], q[:, :2], window=0)
    qd = torch.zeros(2, 4, 16)
    pages = torch.zeros(4, 8, 2, 16)
    tables = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.launch(qd, pages, pages, tables, lens)
    with pytest.raises(ValueError, match="tables"):
        tpa.paged_attention(qd, pages, pages, tables[:1], lens)
    with pytest.raises(ValueError, match="fit"):
        tpa.paged_attention(qd, pages, pages[..., :8], tables, lens)
    # the CUDA kernel's planner refuses a width and a group it does not take
    with pytest.raises(ValueError, match="head widths"):
        tpa.plan(2, 2, 2, 8, 48, 2)
    with pytest.raises(ValueError, match="query heads per kv head"):
        tpa.plan(2, 2, 2, 8, 64, tpa.MAX_GROUP + 1)


ALIGNED = [64 * 512, 64, 32 * 64] * 4   # b, h, s strides of q, k, v, o


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_for_each_dtype_and_width(dtype, hd):
    """bf16 runs on the tensor cores at every width, float32 on them too
    in 3xTF32 at every width: hd 128 and 256 too, as the reference's
    kernel takes any head width in either dtype."""
    td = DTYPES[dtype][1]
    want = "mma_bf16" if dtype == "bfloat16" else "mma_tf32x3"
    assert tfa.kernel_for(td, hd, ALIGNED, [0] * 4) == want


def test_flash_kernel_for_refuses_what_the_mma_kernel_cannot_take():
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="mma_bf16 kernel takes head "
                                         "widths"):
        tfa.kernel_for(bf, 96, ALIGNED, [0] * 4)
    # a width no float32 kernel is built for raises too, and passes to
    # neither the bf16 kernel nor the plain version
    with pytest.raises(ValueError, match="mma_tf32x3 kernel takes head "
                                         "widths"):
        tfa.kernel_for(torch.float32, 96, ALIGNED, [0] * 4)
    odd = list(ALIGNED)
    odd[5] = 66                         # k's s stride
    with pytest.raises(ValueError, match="multiples of 8 elements, got "
                                         r"\[66\]"):
        tfa.kernel_for(bf, 64, odd, [0] * 4)
    with pytest.raises(ValueError, match="16-byte aligned data pointers"):
        tfa.kernel_for(bf, 64, ALIGNED, [0, 2, 0, 0])
    with pytest.raises(TypeError, match="float16"):
        tfa.kernel_for(torch.float16, 64, ALIGNED, [0] * 4)
    # float32 copies 16-byte rows too: strides in whole 4-float units and
    # aligned pointers, or it raises
    with pytest.raises(ValueError, match="mma_tf32x3 kernel needs b, h and "
                                         "s strides that are multiples of 4 "
                                         r"elements, got \[66\]"):
        tfa.kernel_for(torch.float32, 64, odd, [0] * 4)
    with pytest.raises(ValueError, match="16-byte aligned data pointers"):
        tfa.kernel_for(torch.float32, 64, ALIGNED, [0, 4, 0, 0])
    odd[5] = 68                         # 4-float units: taken
    assert tfa.kernel_for(torch.float32, 64, odd, [0] * 4) == "mma_tf32x3"


# The float32 kernel's arithmetic (csrc/flash_attention.cu, flash_tf32x3),
# emulated on the CPU: every product of Q.K^T and P.V in 3xTF32.

LOG2E = 1.4426950408889634
TK_F32 = {64: 64, 128: 32, 256: 16}   # the kernel's keys a tile


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as cvt.rna.tf32.f32 rounds it: 10
    mantissa bits, to nearest, ties away from zero (bit 12 of the
    magnitude added, the low 13 bits cleared)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def mm_tf32x3(a, b):
    """a @ b as the kernel's mma.sync takes it: each operand split into
    TF32 halves, hi.lo + lo.hi, then hi.hi, summed in float32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def mm_tf32(a, b):
    """a @ b in one TF32 pass."""
    return tf32(a) @ tf32(b)


def flash_emulated(q, k, v, window, mm, tk):
    """The kernel's causal flash loop in float32 over [B, H, S, hd]
    tensors: key tiles of ``tk``, the online softmax in base 2 with the
    scale in the exponent, NEG_INF on masked scores, the division by
    max(l, 1e-30), rows that see no key 0; both products through ``mm``."""
    S, hd = q.shape[2], q.shape[3]
    sl = torch.tensor((1.0 / hd ** 0.5) * LOG2E, dtype=torch.float32)
    m = torch.full(q.shape[:3] + (1,), -1e30)
    l = torch.zeros(q.shape[:3] + (1,))
    o = torch.zeros(q.shape)
    qp = torch.arange(S)[:, None]
    for k0 in range(0, k.shape[2], tk):
        kt, vt = k[:, :, k0:k0 + tk], v[:, :, k0:k0 + tk]
        kp = torch.arange(k0, k0 + kt.shape[2])[None, :]
        keep = qp >= kp
        if window is not None:
            keep &= qp - kp < window
        s = torch.where(keep, mm(q, kt.transpose(-1, -2)) * sl,
                        torch.tensor(-1e30))
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        corr, p = torch.exp2(m - mn), torch.exp2(s - mn)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + mm(p, vt)
        m = mn
    return torch.where(m == -1e30, torch.zeros(()), o / l.clamp_min(1e-30))


def attention_f64(q, k, v, window):
    """Causal attention in float64; rows that see no key 0."""
    S, hd = q.shape[2], q.shape[3]
    s = q.double() @ k.double().transpose(-1, -2) / hd ** 0.5
    qp, kp = torch.arange(S)[:, None], torch.arange(k.shape[2])[None, :]
    keep = qp >= kp
    if window is not None:
        keep &= qp - kp < window
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
    return torch.nan_to_num(p) @ v.double()


def test_tf32_rounds_to_nearest_ties_away():
    """The emulation's rounding is cvt.rna's: 1 + 2^-11 is half a TF32
    step above 1 and goes away from zero, in either sign; just below
    half a step goes to 1; a carry out of the mantissa moves the
    exponent."""
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23,
                      2 - 2 ** -23, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 2.0, 3.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    assert not (tf32(x).view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("window", [None, 48])
def test_flash_tf32x3_arithmetic_within_float32_tolerance(hd, window):
    """The float32 kernel's design holds the JAX kernel tests' float32
    tolerance: attention with every Q.K^T and P.V product in 3xTF32 and
    the kernel's online softmax over its key tiles lies within 1e-5 of
    float64 attention, causal and windowed, at the widths of the model
    configs; one TF32 pass on the same inputs lies outside it."""
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 160, hd),
                                                    dtype=np.float32))
               for _ in range(3))
    want = attention_f64(q, k, v, window)
    assert_close(flash_emulated(q, k, v, window, mm_tf32x3, TK_F32[hd]),
                 want, TOL_F32)
    with pytest.raises(AssertionError, match="Not equal to tolerance"):
        assert_close(flash_emulated(q, k, v, window, mm_tf32, TK_F32[hd]),
                     want, TOL_F32)
