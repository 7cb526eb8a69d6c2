"""Training on the port (``Model.loss``, autograd through every family,
``train.train_step``, ``train.trainer``) against the JAX package's.

For every architecture at its smoke config in float32, with parameters
from the JAX init carried across (``params_from_jax``) and one batch of
numpy draws (tokens, a ``loss_mask``, and the family's stub inputs):

- ``Model.loss`` with remat on and off against the reference's loss
  (moe's 0.01 * aux_loss included): 1e-5 absolute on a loss of ~7
  (measured <= 1.5e-6);
- every gradient leaf, stacked as the reference's pytree: max |diff| at
  most 1e-4 of the leaf's largest gradient (the two sum in other orders;
  measured <= 4.6e-6, recurrentgemma-2b's);
- one ``make_train_step`` with ``accum_steps`` 1 and 2 against the
  reference's step: params and both moments within 1e-5 (absolute; the
  parameters are O(1), the moments O(grad)), the step count exact.  With
  one micro-batch the reference's step is its ``adamw.update`` of the
  gradients above, the body of its jitted step; with two it is the
  reference's ``make_train_step`` under ``jax.jit``.

Then the three trainer tests of ``tests/test_trainer_fault.py`` on the
port (granite-3-2b's smoke config in bf16, on the CPU).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_smoke_config as jget_smoke
from repro.models.model import build as jbuild
from repro.optim import adamw as JA
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.train.train_step import TrainConfig, init_state, \
    make_train_step
from repro_torch.train.trainer import LoopConfig, Trainer

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-5
B, S = 2, 32
# eps 1e-3: Adam's first step is g / (|g| + eps), so with the default
# 1e-8 a gradient element within float32 rounding of 0 takes its sign,
# and a parameter its +-lr, from the order of the sums; at 1e-3 the step
# is a smooth function of the gradient and the comparison is of the
# arithmetic
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)


def cfgs(arch):
    return (dataclasses.replace(jget_smoke(arch), dtype="float32"),
            dataclasses.replace(tconfigs.get_smoke_config(arch),
                                dtype="float32"))


def np_batch(cfg, seed=0, mask=True, positions3=True):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if mask:
        out["loss_mask"] = (rng.random((B, S - 1)) < 0.7).astype(np.float32)
    if cfg.family == "vlm":
        P = min(cfg.n_patches, S // 2)
        out["vision_embeds"] = (rng.standard_normal((B, P, cfg.d_model))
                                * 0.02).astype(np.float32)
        if positions3:   # (t, h, w) streams that differ from each other
            pos = np.broadcast_to(np.arange(S), (B, S))
            out["positions3"] = np.stack([pos, pos // 2, pos % 4]).astype(
                np.int32)
    if cfg.family == "encdec":
        out["src_embeds"] = (rng.standard_normal((B, S, cfg.d_model))
                             * 0.02).astype(np.float32)
    return out


def port_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def reference(arch):
    """(params, batch, loss, grads) of the reference, as numpy."""
    jc, _ = cfgs(arch)
    m = jbuild(jc)
    params = m.init(jax.random.PRNGKey(0))
    batch = np_batch(jc)
    loss, grads = jax.jit(jax.value_and_grad(m.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    to_np = functools.partial(jax.tree.map, np.asarray)
    return to_np(params), batch, float(loss), to_np(grads)


def port_model(arch, params):
    _, tc = cfgs(arch)
    m = TM.build(tc, device="cpu")
    return m, TM.params_from_jax(params, tc, device="cpu")


def leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(a, np.float32)
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def as_tree(named):
    """A port name -> tensor dict as the reference's pytree (numpy)."""
    return TM.params_to_numpy({n: t.detach() for n, t in named.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jparams, batch, jloss, jgrads = reference(arch)
    m, params = port_model(arch, jparams)
    st = init_state(params)
    for remat in (True, False):
        loss = m.loss(st.params, port_batch(batch), remat=remat)
        assert abs(float(loss.detach()) - jloss) <= LOSS_TOL, (remat, jloss)
        named = dict(st.params.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        got = leaves(as_tree(dict(zip(named, grads))))
        want = leaves(jgrads)
        assert got.keys() == want.keys()
        for k, w in want.items():
            scale = float(np.max(np.abs(w)))
            err = float(np.max(np.abs(got[k] - w)))
            assert err <= GRAD_TOL * max(scale, 1e-6), (remat, k, err, scale)


def _close_state(ts, jparams, jopt, what):
    assert int(ts.opt.step) == int(jopt.step), what
    for got, want, name in ((ts.params.named_parameters(), jparams, "params"),
                            (ts.opt.mu.items(), jopt.mu, "mu"),
                            (ts.opt.nu.items(), jopt.nu, "nu")):
        g, w = leaves(as_tree(dict(got))), leaves(want)
        assert g.keys() == w.keys()
        for k in w:
            err = float(np.max(np.abs(g[k] - w[k])))
            assert err <= STEP_TOL, (what, name, k, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    jparams, batch, jloss, jgrads = reference(arch)
    jc, _ = cfgs(arch)
    jcfg = JA.AdamWConfig(**OPT)
    # one micro-batch: the reference's update of its gradients
    js = jinit_state(jax.tree.map(jnp.asarray, jparams))
    jp1, jo1, jm1 = JA.update(jcfg, jax.tree.map(jnp.asarray, jgrads), js.opt,
                              js.params)
    m, params = port_model(arch, jparams)
    st = init_state(params)
    step = make_train_step(m, TrainConfig(opt=TA.AdamWConfig(**OPT)))
    st1, met = step(st, port_batch(batch))
    assert abs(float(met["loss"]) - jloss) <= LOSS_TOL
    assert abs(float(met["grad_norm"]) - float(jm1["grad_norm"])) \
        <= 1e-5 * float(jm1["grad_norm"])
    assert float(met["lr"]) == pytest.approx(float(jm1["lr"]), rel=1e-6)
    _close_state(st1, jp1, jo1, "accum 1")
    assert int(st.opt.step) == 0   # the state it was given is untouched

    # two micro-batches: the reference's jitted step (positions3 left
    # out: the reference splits every batch leaf on axis 0, which is 3
    # for M-RoPE's streams)
    b2 = np_batch(jc, seed=1, positions3=False)
    jstep = jax.jit(jmake_train_step(jbuild(jc), JTrainConfig(
        opt=jcfg, accum_steps=2)))
    js2, jm2 = jstep(js, {k: jnp.asarray(v) for k, v in b2.items()})
    step2 = make_train_step(m, TrainConfig(opt=TA.AdamWConfig(**OPT),
                                           accum_steps=2))
    st2, met2 = step2(init_state(port_model(arch, jparams)[1]),
                      port_batch(b2))
    assert abs(float(met2["loss"]) - float(jm2["loss"])) <= LOSS_TOL
    _close_state(st2, js2.params, js2.opt, "accum 2")


def test_loss_mask_and_unmasked_mean():
    """The mask weighs positions: a zero mask on the second row equals
    the loss of the first row alone; no mask is the plain mean."""
    jparams, batch, _, _ = reference("granite-3-2b")
    m, params = port_model("granite-3-2b", jparams)
    b = port_batch(batch)
    with torch.no_grad():
        logits = m.forward(params, b)
        lp = torch.log_softmax(logits[:, :-1].double(), -1)
        nll = -torch.gather(lp, -1, b["tokens"][:, 1:, None].long())[..., 0]
        mask = torch.zeros(B, S - 1)
        mask[0] = 1
        got = m.loss(params, {"tokens": b["tokens"], "loss_mask": mask})
        assert abs(float(got) - float(nll[0].mean())) <= LOSS_TOL
        got = m.loss(params, {"tokens": b["tokens"]})
        assert abs(float(got) - float(nll.mean())) <= LOSS_TOL


def test_aux_loss_matches_reference_with_ties():
    """moe.aux_loss against the reference's on x with rows of zeros,
    whose gates all tie (top-1 goes to expert 0, as argmax), and on a
    router with two equal columns."""
    from repro.models import moe as JMOE
    from repro_torch.models import moe as TMOE

    jc, tc = cfgs("granite-moe-1b-a400m")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, jc.d_model)).astype(np.float32)
    x[0, :5] = 0.0
    router = rng.standard_normal((jc.d_model, jc.n_experts)).astype(
        np.float32)
    router[:, 3] = router[:, 1]
    want = float(JMOE.aux_loss({"router": jnp.asarray(router)},
                               jnp.asarray(x), jc))
    got = float(TMOE.aux_loss(TM.L.MoE(router=torch.from_numpy(router)),
                              torch.from_numpy(x), tc))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


# ------------------------------------------------ the trainer on the port


def _setup(tmp_path, total_steps=12, ckpt_every=4):
    cfg = tconfigs.get_smoke_config("granite-3-2b")
    m = TM.build(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    state = init_state(params)
    tcfg = TrainConfig(opt=TA.AdamWConfig(
        lr=3e-3, warmup_steps=2, total_steps=total_steps))
    step_fn = make_train_step(m, tcfg)
    data = Pipeline(DataConfig(vocab_size=cfg.vocab_size, batch=4,
                               seq_len=32, seed=1))

    def batch_fn(s):
        return {"tokens": torch.from_numpy(data.batch_at(s))}
    loop = LoopConfig(total_steps=total_steps, ckpt_every=ckpt_every,
                      ckpt_dir=str(tmp_path), log_every=1000)
    return state, step_fn, batch_fn, loop


def test_loss_decreases(tmp_path):
    state, step_fn, batch_fn, loop = _setup(tmp_path, total_steps=15)
    tr = Trainer(step_fn, batch_fn, loop)
    state, hist = tr.run(state)
    assert hist[-1] < hist[0], (hist[0], hist[-1])


def test_fault_injection_recovers(tmp_path):
    state, step_fn, batch_fn, loop = _setup(tmp_path, total_steps=12,
                                            ckpt_every=3)
    fired = {"n": 0}

    def fault(step):
        if step == 7 and fired["n"] == 0:
            fired["n"] = 1
            raise RuntimeError("injected node failure")

    tr = Trainer(step_fn, batch_fn, loop, fault_hook=fault)
    state, hist = tr.run(state)
    assert fired["n"] == 1
    assert tr.n_restarts == 1
    assert tr.ckpt.latest_step() == 12


def test_restart_is_deterministic(tmp_path):
    """Crash + resume must produce the same final params as an
    uninterrupted run (same data replay, same updates)."""
    s1, step_fn, batch_fn, loop1 = _setup(tmp_path / "a", total_steps=8,
                                          ckpt_every=2)
    tr1 = Trainer(step_fn, batch_fn, loop1)
    f1, _ = tr1.run(s1)

    s2, step_fn2, batch_fn2, loop2 = _setup(tmp_path / "b", total_steps=8,
                                            ckpt_every=2)

    def fault(step):
        if step == 5 and not getattr(fault, "hit", False):
            fault.hit = True
            raise RuntimeError("boom")

    tr2 = Trainer(step_fn2, batch_fn2, loop2, fault_hook=fault)
    f2, _ = tr2.run(s2)
    assert tr2.n_restarts == 1
    d = [float((a.detach().float() - b.detach().float()).abs().max())
         for a, b in zip(f1.params.parameters(), f2.params.parameters())]
    assert max(d) < 1e-5
