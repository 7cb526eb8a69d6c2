"""Training on the card: the flash_attention and ssd_intra wrappers under
autograd, a train step on ``cuda`` against the same step on ``cpu``, and
restart determinism.

Every test here needs the card: it skips elsewhere with a reason, and
runs on a machine with one through (jax is not needed there, hence
``--noconftest``)

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_train_gpu.py

- The wrappers: under autograd on CUDA tensors the forward launches the
  kernel (counted) and the backward is the VJP of the plain version from
  the saved inputs, so each input's gradient equals the plain version's
  autograd gradient on the same inputs; bound 1e-6 of the largest
  gradient (the same function of the same inputs; only the card's
  reductions could reorder).  The outputs are held to the kernel tests'
  tolerances (1e-5 in float32, two bf16 ulps: 1.6e-2 relative).
- The train step: granite-3-2b's and mamba2-2.7b's smoke configs in
  float32 (flash's ``mma_tf32x3`` and ssd_intra's ``fma_f32`` routes),
  one ``make_train_step`` with ``eps`` 1e-3 (see tests/test_torch_train.py) on ``cuda`` and on
  ``cpu`` from the same weights and batch: loss and gradient norm within
  1e-4 relative, every parameter and moment within 1e-4.
- Restart determinism: tests/test_trainer_fault.py's crash-at-step-5
  run against an uninterrupted one, on the card, within 1e-5.
- granite-moe's smoke config trains in bf16 on the card (the experts'
  products under autograd).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref, ssd_scan
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainConfig, init_state, \
    make_train_step
from repro_torch.train.trainer import LoopConfig, Trainer

pytestmark = pytest.mark.gpu

GRAD_TOL = 1e-6
OUT_TOL = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
STEP_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m gpu on a machine "
                    "that has one")
    return torch.device("cuda")


def leaves(dev, dtype, *shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dev, dtype).requires_grad_() for s in shapes]


def grads_close(got, want):
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= GRAD_TOL * max(scale, 1e-12)


# (B, H, K, S, Sk, hd, causal, window)
FLASH = [(2, 4, 2, 64, 64, 16, True, None), (1, 8, 2, 96, 96, 64, True, 32),
         (2, 4, 4, 40, 72, 32, False, None), (1, 10, 1, 128, 128, 256, True,
                                              64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,Sk,hd,causal,window", FLASH)
def test_flash_gradients_match_plain(cuda, dtype, B, H, K, S, Sk, hd, causal,
                                     window):
    q, k, v = leaves(cuda, dtype, (B, H, S, hd), (B, K, Sk, hd),
                     (B, K, Sk, hd))
    do = leaves(cuda, dtype, (B, H, S, hd), seed=1)[0].detach()
    before = fa.LAUNCHES
    o = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES == before + 1 and o.grad_fn is not None
    got = torch.autograd.grad(o, (q, k, v), do)
    assert fa.LAUNCHES == before + 1      # the backward launches nothing
    want_o = ref.mha_reference(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(want_o, (q, k, v), do)
    np.testing.assert_allclose(o.detach().float().cpu(),
                               want_o.detach().float().cpu(),
                               atol=OUT_TOL[dtype], rtol=OUT_TOL[dtype])
    grads_close(got, want)
    with torch.no_grad():   # serving: the same launch, nothing saved
        assert fa.flash_attention(q, k, v, causal=causal,
                                  window=window).grad_fn is None


@pytest.mark.parametrize("dtype,mode", [(torch.bfloat16, "model"),
                                        (torch.float32, "model"),
                                        (torch.float32, "pallas")])
def test_ssd_intra_gradients_match_plain(cuda, dtype, mode):
    T, q, G, r, p, n = 3, 64, 2, 4, 32, 64
    rng = np.random.default_rng(0)
    x, B, C = leaves(cuda, dtype, (T, q, G * r, p), (T, q, G, n),
                     (T, q, G, n))
    dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                             (T, q, G * r))).astype(
        np.float32)).to(cuda).requires_grad_()
    dA = (dt.detach() * -4.0).requires_grad_()
    ins = (x, dt, dA, B, C)
    dy, dS = [t.detach().float() for t in leaves(
        cuda, torch.float32, (T, q, G * r, p), (T, G * r, n, p), seed=2)]
    if mode == "pallas":
        dy, dS = dy.to(dtype), dS.to(dtype)
    before = ssd_scan.LAUNCHES
    y, S = ssd_scan.ssd_intra(*ins, mode=mode)
    assert ssd_scan.LAUNCHES == before + 1
    got = torch.autograd.grad((y, S), ins, (dy, dS))
    want_y, want_S = ref.ssd_intra_plain(*ins, mode=mode)
    want = torch.autograd.grad((want_y, want_S), ins, (dy, dS))
    tol = OUT_TOL[dtype] if dtype == torch.float32 else 5e-2
    for a, b in ((y, want_y), (S, want_S)):
        np.testing.assert_allclose(a.detach().float().cpu(),
                                   b.detach().float().cpu(), atol=tol,
                                   rtol=tol)
    grads_close(got, want)


def _step(arch, dev):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    m = M.build(cfg, device=dev)
    tree = M.numpy_params(cfg, 0)
    st = init_state(M.params_from_jax(tree, cfg, dev))
    data = Pipeline(DataConfig(vocab_size=cfg.vocab_size, batch=2,
                               seq_len=64, seed=0))
    step = make_train_step(m, TrainConfig(opt=adamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)))
    st, met = step(st, {"tokens": torch.from_numpy(data.batch_at(0))})
    return st, {k: float(v) for k, v in met.items()}


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-2.7b"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    launches = fa.LAUNCHES + ssd_scan.LAUNCHES
    got, gm = _step(arch, cuda)
    assert fa.LAUNCHES + ssd_scan.LAUNCHES > launches   # the kernels ran
    want, wm = _step(arch, "cpu")
    for k in ("loss", "grad_norm"):
        assert abs(gm[k] - wm[k]) <= STEP_TOL * abs(wm[k]), (k, gm, wm)
    assert gm["lr"] == pytest.approx(wm["lr"], rel=1e-6)
    for a, b in ((got.params.named_parameters(),
                  want.params.named_parameters()),
                 (got.opt.mu.items(), want.opt.mu.items()),
                 (got.opt.nu.items(), want.opt.nu.items())):
        for (n, x), (_, y) in zip(a, b):
            err = float((x.detach().cpu() - y.detach()).abs().max())
            assert err <= STEP_TOL, (n, err)


def test_restart_is_deterministic_on_card(cuda, tmp_path):
    cfg = get_smoke_config("granite-3-2b")
    m = M.build(cfg, device=cuda)
    data = Pipeline(DataConfig(vocab_size=cfg.vocab_size, batch=4,
                               seq_len=32, seed=1))
    step_fn = make_train_step(m, TrainConfig(opt=adamw.AdamWConfig(
        lr=3e-3, warmup_steps=2, total_steps=8)))

    def batch_fn(s):
        return {"tokens": torch.from_numpy(data.batch_at(s)).to(cuda)}

    def run(where, fault=None):
        st = init_state(m.init(torch.Generator(cuda).manual_seed(0)))
        tr = Trainer(step_fn, batch_fn, LoopConfig(
            total_steps=8, ckpt_every=2, ckpt_dir=str(tmp_path / where),
            log_every=1000), fault_hook=fault)
        return tr.run(st)[0], tr

    def fault(step):
        if step == 5 and not getattr(fault, "hit", False):
            fault.hit = True
            raise RuntimeError("boom")

    f1, _ = run("a")
    f2, tr2 = run("b", fault)
    assert tr2.n_restarts == 1
    d = [float((a.detach().float() - b.detach().float()).abs().max())
         for a, b in zip(f1.params.parameters(), f2.params.parameters())]
    assert max(d) < 1e-5


def test_moe_bf16_train_step_on_card(cuda):
    """granite-moe's smoke config in bf16: the experts' products widen
    their operands under autograd (the card's bf16-in, float32-out bmm
    has no backward); the step's loss, gradient norm and parameters are
    finite and the parameters move."""
    cfg = get_smoke_config("granite-moe-1b-a400m")
    m = M.build(cfg, device=cuda)
    st = init_state(m.init(torch.Generator(cuda).manual_seed(0)))
    data = Pipeline(DataConfig(vocab_size=cfg.vocab_size, batch=2,
                               seq_len=64, seed=0))
    step = make_train_step(m, TrainConfig(opt=adamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10)))
    new, met = step(st, {"tokens": torch.from_numpy(data.batch_at(0))})
    assert np.isfinite(float(met["loss"])) and np.isfinite(
        float(met["grad_norm"]))
    moved = [float((a.detach().float() - b.detach().float()).abs().max())
             for a, b in zip(st.params.parameters(), new.params.parameters())]
    assert all(np.isfinite(moved)) and max(moved) > 0
