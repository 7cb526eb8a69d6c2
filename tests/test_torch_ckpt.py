"""The port's checkpoint manager (``repro_torch.ckpt.checkpoint``): the
reference's five checkpoint tests of ``tests/test_substrates.py`` on the
port, and its on-disk layout against the JAX package's in both
directions: a ``TrainState`` the port writes restores in
``repro.ckpt`` into the reference's ``TrainState`` leaf for leaf
(exact: bf16 as its bits), and the other way round.  bf16 leaves are
also written and restored with ``ml_dtypes`` blocked, in a subprocess:
the port must not need ``ml_dtypes``."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JManager
from repro.configs import get_smoke_config as jget_smoke
from repro.models.model import build as jbuild
from repro.optim.adamw import OptState as JOptState
from repro.train.train_step import TrainState as JTrainState
from repro_torch import configs as tconfigs
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.models import model as TM
from repro_torch.optim.adamw import OptState
from repro_torch.train.train_step import TrainState, init_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 8), generator=g),
            "opt": {"m": torch.zeros((8, 8)),
                    "step": torch.tensor(3, dtype=torch.int32)}}


def test_ckpt_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_write=False)
    s = _state()
    mgr.save(10, s)
    restored, step = mgr.restore(s)
    assert step == 10
    assert torch.equal(restored["w"], s["w"])
    assert restored["opt"]["step"].dtype == torch.int32
    assert int(restored["opt"]["step"]) == 3


def test_ckpt_keep_n_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_write=False)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state(step))
    assert mgr.all_steps() == [3, 4]
    restored, step = mgr.restore(_state())
    assert step == 4
    assert torch.equal(restored["w"], _state(4)["w"])


def test_ckpt_atomic_no_partial(tmp_path):
    """A stray .tmp dir (simulated crash) must be invisible to restore."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(5, _state())
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert mgr.latest_step() == 5


def test_ckpt_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(7, _state())
    mgr.wait()
    assert mgr.latest_step() == 7


def test_ckpt_digest_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, _state())
    d = os.path.join(str(tmp_path), "step_00000001")
    data = dict(np.load(os.path.join(d, "arrays.npz")))
    data["a0"] = data["a0"] + 1.0
    np.savez(os.path.join(d, "arrays.npz"), **data)
    with pytest.raises(IOError):
        mgr.restore(_state())


def test_ckpt_refuses_another_structure(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, _state())
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.zeros(8, 8)})
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.zeros(4, 8), "opt": _state()["opt"]})


# ------------------------------------------------ across the two packages


def _states(arch="granite-3-2b", seed=0):
    """A reference TrainState and the port's equal one: the smoke config
    (bf16 matrices, float32 norms), params from the JAX init, moments and
    step drawn from numpy."""
    jc = jget_smoke(arch)
    tc = tconfigs.get_smoke_config(arch)
    jp = jbuild(jc).init(jax.random.PRNGKey(seed))
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(seed)
    jmu = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), jp)
    jnu = jax.tree.map(lambda a: jnp.asarray(
        rng.random(a.shape).astype(np.float32)), jp)
    js = JTrainState(params=jp, opt=JOptState(step=jnp.int32(7), mu=jmu,
                                              nu=jnu))
    names = [n for n, _ in tp.named_parameters()]

    def moments(tree):
        flat = TM.jax_layout(names)
        out = {}
        for path, ns in flat.items():
            a = tree
            for k in path:
                a = a[k]
            a = np.asarray(a)
            for i, n in enumerate(ns):
                out[n] = torch.from_numpy(np.array(
                    a[i] if TM.jax_path(n)[1] is not None else a))
        return out

    ts = TrainState(params=tp, opt=OptState(
        step=torch.tensor(7, dtype=torch.int32), mu=moments(jmu),
        nu=moments(jnu)))
    return js, ts


def _jleaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def _tleaves(state):
    """The port's state as the reference's leaves, through the reference's
    own layout (params_to_numpy; moments stacked the same way)."""
    out = jax.tree.leaves(TM.params_to_numpy(state.params))
    out.append(state.opt.step.numpy())
    for m in (state.opt.mu, state.opt.nu):
        out += jax.tree.leaves(TM.params_to_numpy(m))
    return out


def _same(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and str(a.dtype) == str(b.dtype), i
        assert a.tobytes() == b.tobytes(), i


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-2.7b",
                                  "recurrentgemma-2b"])
def test_port_checkpoint_restores_in_reference(tmp_path, arch):
    js, ts = _states(arch)
    CheckpointManager(str(tmp_path), async_write=False).save(7, ts)
    like = JTrainState(params=jax.tree.map(jnp.zeros_like, js.params),
                       opt=jax.tree.map(jnp.zeros_like, js.opt))
    restored, step = JManager(str(tmp_path)).restore(like)
    assert step == 7
    _same(_jleaves(restored), _jleaves(js))


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-2.7b",
                                  "recurrentgemma-2b"])
def test_reference_checkpoint_restores_in_port(tmp_path, arch):
    js, ts = _states(arch, seed=1)
    JManager(str(tmp_path), async_write=False).save(7, js)
    tc = tconfigs.get_smoke_config(arch)
    like = init_state(TM.build(tc, device="cpu").init(
        torch.Generator().manual_seed(0)))
    restored, step = CheckpointManager(str(tmp_path)).restore(
        like, device="cpu")
    assert step == 7
    _same(_tleaves(restored), _jleaves(js))
    assert all(p.requires_grad for p in restored.params.parameters())


_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None
import torch
from repro_torch import configs
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.models.model import build
from repro_torch.train.train_step import init_state
try:
    import ml_dtypes  # noqa: F401
    raise SystemExit("ml_dtypes was importable")
except ImportError:
    pass
cfg = configs.get_smoke_config("granite-3-2b")
m = build(cfg, device="cpu")
st = init_state(m.init(torch.Generator().manual_seed(3)))
assert st.params.embed.tok.dtype == torch.bfloat16
mgr = CheckpointManager(sys.argv[1], async_write=False)
mgr.save(2, st)
back, step = mgr.restore(init_state(m.init(torch.Generator().manual_seed(4))))
assert step == 2
for (n, a), (_, b) in zip(st.params.named_parameters(),
                          back.params.named_parameters()):
    assert a.dtype == b.dtype and torch.equal(a, b), n
print("ok")
"""


def test_bf16_without_ml_dtypes(tmp_path):
    """The port writes and restores bf16 leaves with ml_dtypes blocked;
    the reference restores that checkpoint too."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES,
                          str(tmp_path)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    jc = jget_smoke("granite-3-2b")
    jp = jbuild(jc).init(jax.random.PRNGKey(0))
    like = JTrainState(params=jp, opt=JOptState(
        step=jnp.int32(0), mu=jax.tree.map(jnp.zeros_like, jp),
        nu=jax.tree.map(jnp.zeros_like, jp)))
    restored, step = JManager(str(tmp_path)).restore(like)
    assert step == 2
    assert restored.params["embed"]["tok"].dtype == jnp.bfloat16
