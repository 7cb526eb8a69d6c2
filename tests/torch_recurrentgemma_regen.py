"""Regenerate tests/golden/torch_recurrentgemma_fullwidth.json.

The snapshot holds what the JAX package's recurrentgemma-2b serves at
full width (d_model 2560, 10 query heads of 256 on one kv head, lru
width 2560, d_ff 7680, vocab 256,000, window 2048) with its depth cut to
3 layers, one superblock of (rec, rec, attn) -- 2 layers would be the
tail alone, which has no attention -- in bfloat16:
``repro.models.model.Model.prefill`` over a B=2 x 256-token prompt (the
hybrid's prefill fills no cache, as the ssm family's), then 4 greedy
``decode_step``s from ``init_cache`` over a cache of 256 positions, at
positions 0..3, on the CPU.

The weights are ``repro_torch.models.model.numpy_params(cfg, SEED)``
(float32 numpy draws from ``default_rng(SEED)``, with the RG-LRU's
a_param drawn as the reference initialises it, so that the recurrence
remembers over the prompt), cast to the dtypes ``repro.models.rglru``
initialises them in; the prompt is drawn from ``default_rng(SEED + 1)``.
For the prefill's last position and each decode step the snapshot keeps
the top-8 logits and their ids, the logsumexp, the greedy token and the
top-2 margin, with sha256 digests of the weights and of the prompt that
``chip_smoke.py`` checks before it compares any logit.

Usage:  PYTHONPATH=src python tests/torch_recurrentgemma_regen.py
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models.model import build
from repro_torch.models.model import numpy_params, tree_sha256
from torch_mamba2_regen import jax_params, summary

SEED = 0
N_LAYERS = 3
BATCH, PROMPT, CACHE, STEPS, TOP = 2, 256, 256, 4, 8
OUT = os.path.join(os.path.dirname(__file__), "golden",
                   "torch_recurrentgemma_fullwidth.json")


def main():
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"),
                              n_layers=N_LAYERS)
    tree = numpy_params(cfg, SEED)
    prompt = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    m = build(cfg)
    params = jax_params(tree, cfg)
    logits, cache = m.prefill(params, {"tokens": jnp.asarray(prompt)})
    assert cache is None
    steps = [summary(logits[:, -1])]
    del logits
    cache = m.init_cache(BATCH, CACHE)
    tok = np.asarray(steps[-1]["token"], np.int32)[:, None]
    for i in range(STEPS):
        pos = jnp.full((BATCH,), i, jnp.int32)
        logits, cache = m.decode_step(params, cache, jnp.asarray(tok), pos)
        steps.append(summary(logits[:, -1]))
        tok = np.asarray(steps[-1]["token"], np.int32)[:, None]
        print(f"[recurrentgemma] step {i}: tokens {steps[-1]['token']}",
              flush=True)
    snap = {"config": cfg.name, "n_layers": N_LAYERS, "dtype": cfg.dtype,
            "seed": SEED, "batch": BATCH, "prompt_len": PROMPT,
            "cache_len": CACHE, "decode_steps": STEPS, "top": TOP,
            "weights_sha256": tree_sha256(tree),
            "prompt_sha256": tree_sha256({}, prompt),
            "steps": steps}
    with open(OUT, "w") as f:
        json.dump(snap, f, indent=1)
        f.write("\n")
    print(f"[recurrentgemma] wrote {OUT}")


if __name__ == "__main__":
    main()
