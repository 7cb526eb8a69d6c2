"""The model families and options of the port's ninth slice on the card:
each path through the attention kernels against the same path through
their plain versions (``kernels.ref``), on the same weights and tokens.

Every test here needs the card: it skips elsewhere with a reason, and
runs on a machine with one through (jax is not needed there, hence
``--noconftest``)

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_models_gpu.py

Smoke configs run in float32, where the kernels take every smoke head
width (16) and meet the JAX kernel tests' 1e-5 a call: the logits are
held to 1e-4, the CPU tests' float32 model bound, and the moe routes of
the two runs must be equal.  Two layers at full width run in bf16, held
to 3e-2 (the paged kernel's bf16 tolerance) of the largest logit, the
bound chip_smoke.py phase 16 uses and explains; a moe step is compared
where the two runs routed every token alike (a near tie can flip an
expert between two bf16 runs), and at least one step must be.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe

pytestmark = pytest.mark.gpu

NEW = ["granite-moe-1b-a400m", "mixtral-8x7b", "seamless-m4t-medium",
       "qwen3-32b", "phi3-medium-14b", "yi-6b", "qwen2-vl-7b"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m gpu on a machine "
                    "that has one")
    return torch.device("cuda")


def plain(monkeypatch):
    """Route the model's attention through the plain versions."""
    def flash(q, k, v, *, causal=True, window=None):
        return ref.mha_reference(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window).transpose(1, 2)
    monkeypatch.setattr(ops, "flash_attention", flash)
    monkeypatch.setattr(ops, "paged_attention", ref.paged_attention_reference)


def serve(m, params, batch, steps, cache_len, monkeypatch, tokens=None):
    """Prefill and greedy decode steps (``tokens`` fed if given): the
    logits of each, the tokens fed, and each step's routes (experts and
    kept slots of every moe layer, as tuples of tensors)."""
    seen = []
    route = moe.route

    def record(p, x, cfg):
        r = route(p, x, cfg)
        seen.append((torch.sort(r.topi, -1).values, r.keep))
        return r
    monkeypatch.setattr(moe, "route", record)
    B, S = batch["tokens"].shape
    ed = m.cfg.family == "encdec"
    if ed:
        lg, _ = m.prefill(params, batch)
        cache = m.init_cache(B, cache_len, L.dtype_of(m.cfg))
        enc = encdec.encode(params, m.cfg, batch["src_embeds"].to(m.device))
        for i, lp in enumerate(params.dec):
            for name, w in (("xk", lp.cross.wk), ("xv", lp.cross.wv)):
                cache[name][i, :, :enc.shape[1]] = L.matmul(enc, w).reshape(
                    B, enc.shape[1], m.cfg.n_kv_heads, m.cfg.hd)
    else:
        lg, cache = m.prefill(params, batch,
                              m.init_cache(B, cache_len, L.dtype_of(m.cfg)))
    out, fed, routes = [lg], [], [seen[:]]
    for i in range(steps):
        del seen[:]
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None] \
            if tokens is None else tokens[i]
        fed.append(tok)
        pos = torch.full((B,), i if ed else S + i, dtype=torch.int32,
                         device=m.device)
        lg, cache = m.decode_step(params, cache, tok, pos)
        out.append(lg)
        routes.append(seen[:])
    monkeypatch.setattr(moe, "route", route)
    return out, fed, routes


def same_routes(a, b) -> bool:
    return all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
               for x, y in zip(a, b))


def kernel_vs_plain(cfg, dev, monkeypatch, B, S, steps, cache_len, tol,
                    page=16, routes_equal=False, scaled=False):
    m = M.build(cfg, dev, page=page)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = m.init(gen)
    batch = M.dummy_batch(cfg, B, S, gen)
    before = (fa.LAUNCHES, pa.LAUNCHES)
    kern, fed, kroutes = serve(m, params, batch, steps, cache_len,
                               monkeypatch)
    assert fa.LAUNCHES > before[0] and pa.LAUNCHES > before[1]
    with monkeypatch.context() as mp:
        plain(mp)
        want, _, proutes = serve(m, params, batch, steps, cache_len, mp, fed)
    compared = 0
    for a, b, ra, rb in zip(kern, want, kroutes, proutes):
        if routes_equal:
            assert same_routes(ra, rb)
        elif not same_routes(ra, rb):
            continue
        assert torch.isfinite(a).all()
        if scaled:
            assert float((a - b).abs().max()) <= tol * float(b.abs().max())
        else:
            torch.testing.assert_close(a, b, atol=tol, rtol=tol)
        compared += 1
    assert compared > 0


@pytest.mark.parametrize("arch", NEW)
def test_smoke_kernel_path_matches_plain(cuda, monkeypatch, arch):
    """float32 smoke configs; mixtral prefilled past its window of 32 and
    decoded across the ring's wrap (pages of 16)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    S = 40 if cfg.window else 32
    kernel_vs_plain(cfg, cuda, monkeypatch, 2, S, 28, 64, 1e-4,
                    routes_equal=True)


@pytest.mark.parametrize("arch", NEW)
def test_full_width_kernel_path_matches_plain(cuda, monkeypatch, arch):
    """bf16, full width, 2 layers (seamless: 2 + 2), 2 x 256 tokens, 4
    decode steps over a cache of 384 in pages of 128."""
    cfg = dataclasses.replace(get_config(arch), n_layers=2,
                              n_enc_layers=2 if arch.startswith("seamless")
                              else 0)
    kernel_vs_plain(cfg, cuda, monkeypatch, 2, 256, 4, 384, 3e-2, page=128,
                    scaled=True)
