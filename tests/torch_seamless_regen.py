"""Regenerate tests/golden/torch_seamless_fullwidth.json.

The snapshot holds what the JAX package's seamless-m4t-medium serves at
full width (d_model 1024, 16 heads MHA, d_ff 4096, vocab 256,206) with
its depth cut to 2 encoder and 2 decoder layers, in bfloat16, on the CPU:

- ``repro.models.model.Model.prefill`` (the forward's last logits; the
  encdec prefill returns no cache) for a B=2 batch of 256 target tokens
  over 256 source frames;
- 4 greedy ``decode_step``s from position 0 over a cache of 256
  positions, the first fed the target's first token, whose cross cache
  ``xk``/``xv`` holds each decoder layer's ``cross.wk``/``wv``
  projection of ``encode``'s output (filled here: neither package fills
  it, see repro_torch.models.encdec).

The weights are ``repro_torch.models.model.numpy_params(cfg, SEED)``
cast to the dtypes ``repro.models`` initialises them in; the target
tokens are drawn from ``default_rng(SEED + 1)``, the source frames
(normal, then bf16) from ``default_rng(SEED + 2)``.  For each compared
position the snapshot keeps the top-8 logits and their ids, the
logsumexp, the greedy token and the top-2 margin, with digests of the
weights and of the inputs that ``chip_smoke.py`` checks first.

Usage:  PYTHONPATH=src python tests/torch_seamless_regen.py   (~1 min)
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import encdec
from repro.models import layers as L
from repro.models.model import build
from repro_torch.models.model import numpy_params, tree_sha256

from torch_granite_moe_regen import jax_params, summary

SEED = 0
N_LAYERS = 2
BATCH, PROMPT, SOURCE, CACHE, STEPS, TOP = 2, 256, 256, 256, 4, 8
OUT = os.path.join(os.path.dirname(__file__), "golden",
                   "torch_seamless_fullwidth.json")


def inputs(cfg):
    """(target tokens [B, PROMPT] int32, source frames [B, SOURCE, D]
    float32 rounded to bf16)."""
    tokens = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    src = np.random.default_rng(SEED + 2).standard_normal(
        (BATCH, SOURCE, cfg.d_model), dtype=np.float32)
    return tokens, np.asarray(jnp.asarray(src, jnp.bfloat16), np.float32)


def main():
    cfg = dataclasses.replace(get_config("seamless-m4t-medium"),
                              n_layers=N_LAYERS, n_enc_layers=N_LAYERS)
    tree = numpy_params(cfg, SEED)
    tokens, src = inputs(cfg)
    m = build(cfg)
    weights_sha256 = tree_sha256(tree)
    params = jax_params(tree, cfg)
    del tree
    batch = {"tokens": jnp.asarray(tokens),
             "src_embeds": jnp.asarray(src, jnp.bfloat16)}
    logits, none = jax.jit(m.prefill)(params, batch)
    assert none is None
    steps = [summary(logits[:, -1])]
    print(f"[seamless] prefill: tokens {steps[-1]['token']}", flush=True)
    enc = jax.jit(lambda p, s: encdec.encode(p, cfg, s, remat=False))(
        params, batch["src_embeds"])
    cache = m.init_cache(BATCH, CACHE)
    K, hd = cfg.n_kv_heads, cfg.hd
    for name, w in (("xk", "wk"), ("xv", "wv")):
        proj = [L.matmul(enc, params["dec"]["cross"][w][i]).reshape(
            BATCH, SOURCE, K, hd) for i in range(cfg.n_layers)]
        cache[name] = cache[name].at[:, :, :SOURCE].set(
            jnp.stack(proj).astype(cache[name].dtype))
    decode = jax.jit(m.decode_step)
    tok = tokens[:, :1]
    for i in range(STEPS):
        pos = jnp.full((BATCH,), i, jnp.int32)
        logits, cache = decode(params, cache, jnp.asarray(tok), pos)
        steps.append(summary(logits[:, -1]))
        tok = np.asarray(steps[-1]["token"], np.int32)[:, None]
        print(f"[seamless] step {i}: tokens {steps[-1]['token']}",
              flush=True)
    snap = {"config": cfg.name, "n_layers": N_LAYERS,
            "n_enc_layers": N_LAYERS, "dtype": cfg.dtype, "seed": SEED,
            "batch": BATCH, "prompt_len": PROMPT, "source_len": SOURCE,
            "cache_len": CACHE, "decode_steps": STEPS, "top": TOP,
            "weights_sha256": weights_sha256,
            "inputs_sha256": tree_sha256({}, tokens, src),
            "steps": steps}
    with open(OUT, "w") as f:
        json.dump(snap, f, indent=1)
        f.write("\n")
    print(f"[seamless] wrote {OUT}")


if __name__ == "__main__":
    main()
