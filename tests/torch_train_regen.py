"""Regenerate tests/golden/torch_granite_train.json.

The snapshot holds what the JAX package's training gives for
granite-3-2b at full width (d_model 2048, 32/8 heads, d_ff 8192, vocab
49,155) with its depth cut to 2 layers, in float32, on the CPU: three
steps of ``repro.train.train_step.make_train_step`` (AdamW with
``ADAMW``, one micro-batch, remat on) over B=2 x 256-token batches from
``repro.data.pipeline`` (seed 0, steps 0-2).

The weights are ``repro_torch.models.model.numpy_params(cfg, SEED)``
(float32 numpy draws from ``default_rng(SEED)``, the weights of
``torch_granite_fullwidth.json``).  The snapshot keeps sha256 digests of
the weights and of the three batches, which ``chip_smoke.py`` phase 18
checks first; then per step the loss, the gradient's global norm and
the learning rate; the norm of each leaf of step 0's gradient (leaves
by JAX path, layers stacked); and the norm of each leaf's change over
the three steps, which shows a weight decay applied to the wrong
leaves.

Usage:  PYTHONPATH=src python tests/torch_train_regen.py
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.data.pipeline import DataConfig, Pipeline
from repro.models.model import build
from repro.optim import adamw
from repro.train.train_step import TrainConfig, init_state, make_train_step
from repro_torch.models.model import numpy_params, tree_sha256

SEED = 0
N_LAYERS = 2
BATCH, SEQ, STEPS = 2, 256, 3
ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=10)
OUT = os.path.join(os.path.dirname(__file__), "golden",
                   "torch_granite_train.json")


def leaf_norms(tree) -> dict:
    """JAX path -> the leaf's L2 norm (float64 sums)."""
    return {"/".join(str(k.key) for k in path):
            float(np.sqrt(np.sum(np.square(np.asarray(a, np.float64)))))
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def main():
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=N_LAYERS,
                              dtype="float32")
    tree = numpy_params(cfg, SEED)
    data = Pipeline(DataConfig(vocab_size=cfg.vocab_size, batch=BATCH,
                               seq_len=SEQ, seed=SEED))
    batches = [data.batch_at(s) for s in range(STEPS)]
    m = build(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    g0 = jax.jit(jax.grad(m.loss))(params, {"tokens": jnp.asarray(
        batches[0])})
    grad_norms = leaf_norms(g0)
    del g0
    step = jax.jit(make_train_step(m, TrainConfig(
        opt=adamw.AdamWConfig(**ADAMW))))
    state = init_state(params)
    steps = []
    for s, b in enumerate(batches):
        state, met = step(state, {"tokens": jnp.asarray(b)})
        steps.append({k: float(v) for k, v in met.items()})
        print(f"[train] step {s}: {steps[-1]}", flush=True)
    change = leaf_norms(jax.tree.map(lambda a, b: np.asarray(a) - b,
                                     state.params, tree))
    snap = {"config": cfg.name, "n_layers": N_LAYERS, "dtype": cfg.dtype,
            "seed": SEED, "batch": BATCH, "seq_len": SEQ,
            "adamw": ADAMW, "weights_sha256": tree_sha256(tree),
            "batches_sha256": tree_sha256({}, *batches),
            "steps": steps, "grad_norms_step0": grad_norms,
            "param_change_norms": change}
    with open(OUT, "w") as f:
        json.dump(snap, f, indent=1)
        f.write("\n")
    print(f"[train] wrote {OUT}")


if __name__ == "__main__":
    main()
