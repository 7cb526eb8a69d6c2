"""recurrentgemma-2b's path on the card: the flash kernel at hd 256
against its plain version, the full-width snapshot, and the smoke model's
kernel path against its plain path.

Every test here needs the card: it skips elsewhere with a reason, and
runs on a machine with one through (jax is not needed there, hence
``--noconftest``)

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_rglru_gpu.py

Tolerances: the flash kernel in bf16 at the JAX kernel tests' 2e-2, in
float32 at their 1e-5; the full-width snapshot (3 layers, bf16) at 2e-2
on the top-8 logits and the logsumexp, chip_smoke.py's SNAP_TOL (the
port's plain path on a CPU: 3.5e-3); the smoke model in float32 at
1e-4, the CPU tests' float32 model bound.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import model as M

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_recurrentgemma_fullwidth.json")
SNAP_TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m gpu on a machine "
                    "that has one")
    return torch.device("cuda")


@pytest.mark.parametrize("B,S,Sk,causal,window,layout", [
    (2, 512, 512, True, 2048, True),     # the prefill's shape, smaller B
    (1, 4096, 4096, True, 2048, True),   # the window binds
    (2, 77, 200, True, None, False),     # ragged, S != Sk
    (2, 200, 77, False, None, False),
    (2, 200, 77, False, 50, False),      # rows 126.. see no key: 0
    (2, 300, 300, True, 128, True),      # the window binds, ragged
])
def test_flash_hd256_matches_plain(cuda, B, S, Sk, causal, window, layout):
    rng = np.random.default_rng(0)

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(cuda).bfloat16()
    H, K, hd = 10, 1, 256
    if layout:
        q = draw((B, S, H, hd)).transpose(1, 2)
        k, v = (draw((B, Sk, K, hd)).transpose(1, 2) for _ in range(2))
    else:
        q, k, v = draw((B, H, S, hd)), draw((B, K, Sk, hd)), \
            draw((B, K, Sk, hd))
    before = fa.LAUNCHES_BY_KERNEL["mma_bf16"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES_BY_KERNEL["mma_bf16"] == before + 1
    want = ref.mha_reference(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_hd256_float32_matches_plain(cuda):
    """float32 at hd 256 launches the 3xTF32 tensor-core kernel
    (mma_tf32x3, flash_tf32x3<256>) and matches the plain version within
    the float32 tolerance of the JAX kernel tests, 1e-5, at the prefill's
    local-attention shape under a window that binds."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        s, dtype=np.float32)).to(cuda) for s in
        ((1, 10, 512, 256), (1, 1, 512, 256), (1, 1, 512, 256)))
    before = fa.LAUNCHES_BY_KERNEL["mma_tf32x3"]
    got = fa.flash_attention(q, k, v, causal=True, window=64)
    assert fa.LAUNCHES_BY_KERNEL["mma_tf32x3"] == before + 1
    want = ref.mha_reference(q, k, v, causal=True, window=64)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_full_width_snapshot_on_the_card(cuda):
    """3 layers at full width against the JAX snapshot: prefill, then 4
    decode steps from init_cache at positions 0..3."""
    with open(GOLDEN) as f:
        snap = json.load(f)
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"),
                              n_layers=snap["n_layers"])
    tree = M.numpy_params(cfg, snap["seed"])
    assert M.tree_sha256(tree) == snap["weights_sha256"]
    B, S = snap["batch"], snap["prompt_len"]
    prompt = np.random.default_rng(snap["seed"] + 1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    m = M.build(cfg, cuda)
    params = M.params_from_jax(tree, cfg, cuda)
    del tree
    before = (fa.LAUNCHES, pa.LAUNCHES)
    logits, _ = m.prefill(params, {"tokens": torch.from_numpy(prompt)})
    cache = m.init_cache(B, snap["cache_len"])
    for i, st in enumerate(snap["steps"]):
        if i:
            tok = torch.tensor(snap["steps"][i - 1]["token"],
                               dtype=torch.int32)[:, None]
            logits, cache = m.decode_step(
                params, cache, tok, torch.full((B,), i - 1, dtype=torch.int32))
        lg = logits[:, -1].float().cpu()
        got = torch.gather(lg, 1, torch.tensor(st["top_ids"])).numpy()
        np.testing.assert_allclose(got, st["top_logits"], atol=SNAP_TOL)
        np.testing.assert_allclose(torch.logsumexp(lg, -1).numpy(),
                                   st["logsumexp"], atol=SNAP_TOL)
        for b in range(B):
            if st["margin"][b] > SNAP_TOL:
                assert int(lg[b].argmax()) == st["token"][b]
    assert (fa.LAUNCHES - before[0], pa.LAUNCHES - before[1]) == \
        (1, snap["decode_steps"])


def test_smoke_kernel_path_matches_plain(cuda, monkeypatch):
    """float32 smoke config: prefill over 40 tokens (past the window of
    16), then 20 greedy decode steps from init_cache at position 0
    through the ring's wrap (pages of 16), kernels against plain."""
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              dtype="float32")
    m = M.build(cfg, cuda, page=16)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = m.init(gen)
    batch = M.dummy_batch(cfg, 2, 40, gen)

    def serve(tokens=None):
        lg, _ = m.prefill(params, batch)
        out, fed, cache = [lg], [], m.init_cache(2, 32, torch.float32)
        for i in range(20):
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None] \
                if tokens is None else tokens[i]
            fed.append(tok)
            lg, cache = m.decode_step(params, cache, tok,
                                      torch.full((2,), i, dtype=torch.int32,
                                                 device=cuda))
            out.append(lg)
        return out, fed

    before = (fa.LAUNCHES_BY_KERNEL["mma_tf32x3"], pa.LAUNCHES)
    kern, fed = serve()
    assert fa.LAUNCHES_BY_KERNEL["mma_tf32x3"] == before[0] + 1
    assert pa.LAUNCHES == before[1] + 20

    def flash(q, k, v, *, causal=True, window=None):
        return ref.mha_reference(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window).transpose(1, 2)
    monkeypatch.setattr(ops, "flash_attention", flash)
    monkeypatch.setattr(ops, "paged_attention", ref.paged_attention_reference)
    plain, _ = serve(fed)
    for a, b in zip(kern, plain):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
