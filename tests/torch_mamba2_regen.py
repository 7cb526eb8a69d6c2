"""Regenerate tests/golden/torch_mamba2_fullwidth.json.

The snapshot holds what the JAX package's mamba2-2.7b serves at full
width (d_model 2560, 80 heads of 64, state 128, chunk 128, vocab 50,280)
with its depth cut to 2 layers, in bfloat16: ``repro.models.model.Model
.prefill`` over a B=2 x 256-token prompt (two chunks, so the inter-chunk
recurrence runs), then 4 greedy ``decode_step``s from ``init_cache`` (the
reference's ssm prefill returns no cache), on the CPU.

The weights are ``repro_torch.models.model.numpy_params(cfg, SEED)``
(float32 numpy draws from ``default_rng(SEED)``, with Mamba-2's
published A and dt init, so that a chunk's decay passes the kernel's clip
at -60), cast to the dtypes ``repro.models.ssm`` initialises them in; the
prompt is drawn from ``default_rng(SEED + 1)``.  For the prefill's last
position and each decode step the snapshot keeps the top-8 logits and
their ids, the logsumexp, the greedy token and the top-2 margin, with
sha256 digests of the weights and of the prompt that ``chip_smoke.py``
checks before it compares any logit.

Usage:  PYTHONPATH=src python tests/torch_mamba2_regen.py
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models.model import build
from repro_torch.models.model import F32_LEAVES, numpy_params, tree_sha256

SEED = 0
N_LAYERS = 2
BATCH, PROMPT, STEPS, TOP = 2, 256, 4, 8
OUT = os.path.join(os.path.dirname(__file__), "golden",
                   "torch_mamba2_fullwidth.json")


def jax_params(tree, cfg):
    """The numpy tree as JAX arrays in the dtypes repro.models.ssm.init
    gives them: float32 norm scales, conv_b, dt_bias, A_log and Dskip,
    matrices in cfg.dtype."""
    def leaf(path, a):
        f32 = getattr(path[-1], "key", None) in F32_LEAVES
        return jnp.asarray(a, jnp.float32 if f32 else jnp.dtype(cfg.dtype))
    return jax.tree_util.tree_map_with_path(leaf, tree)


def summary(logits) -> dict:
    """Top-k, logsumexp, greedy token and top-2 margin of [B, V] logits."""
    lg = np.asarray(logits, np.float32)
    ids = np.argsort(-lg, axis=-1, kind="stable")[:, :TOP]
    top = np.take_along_axis(lg, ids, axis=-1)
    lse = np.asarray(jax.nn.logsumexp(jnp.asarray(lg), axis=-1))
    return {"top_ids": ids.tolist(), "top_logits": top.tolist(),
            "logsumexp": lse.tolist(),
            "token": np.argmax(lg, axis=-1).tolist(),
            "margin": (top[:, 0] - top[:, 1]).tolist()}


def main():
    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=N_LAYERS)
    tree = numpy_params(cfg, SEED)
    prompt = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    m = build(cfg)
    params = jax_params(tree, cfg)
    logits, cache = m.prefill(params, {"tokens": jnp.asarray(prompt)})
    assert cache is None
    steps = [summary(logits[:, -1])]
    cache = m.init_cache(BATCH, PROMPT)
    tok = np.asarray(steps[-1]["token"], np.int32)[:, None]
    for i in range(STEPS):
        pos = jnp.full((BATCH,), PROMPT + i, jnp.int32)
        logits, cache = m.decode_step(params, cache, jnp.asarray(tok), pos)
        steps.append(summary(logits[:, -1]))
        tok = np.asarray(steps[-1]["token"], np.int32)[:, None]
        print(f"[mamba2] step {i}: tokens {steps[-1]['token']}", flush=True)
    snap = {"config": cfg.name, "n_layers": N_LAYERS, "dtype": cfg.dtype,
            "seed": SEED, "batch": BATCH, "prompt_len": PROMPT,
            "decode_steps": STEPS, "top": TOP,
            "weights_sha256": tree_sha256(tree),
            "prompt_sha256": tree_sha256({}, prompt),
            "steps": steps}
    with open(OUT, "w") as f:
        json.dump(snap, f, indent=1)
        f.write("\n")
    print(f"[mamba2] wrote {OUT}")


if __name__ == "__main__":
    main()
