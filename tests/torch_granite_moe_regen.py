"""Regenerate tests/golden/torch_granite_moe_fullwidth.json.

The snapshot holds what the JAX package's granite-moe-1b-a400m serves at
full width (d_model 1024, 16/8 heads, 32 experts of d_ff 512, top 8,
vocab 49,155) with its depth cut to 2 layers, in bfloat16:
``repro.models.model.Model.prefill`` over a B=2 x 256-token prompt (one
routing group of 512), then 4 greedy ``decode_step``s (each a group of
B = 2, capacity 1) over a cache of 384 positions (the prefill's cache
copied in at [0, 256)), on the CPU.

The weights are ``repro_torch.models.model.numpy_params(cfg, SEED)``
(float32 numpy draws from ``default_rng(SEED)``; the experts with the
reference's fan-in), cast to the dtypes ``repro.models`` initialises
them in; the prompt is drawn from ``default_rng(SEED + 1)``.  For the
prefill's last position and each decode step the snapshot keeps, as
tests/torch_granite_regen.py does, the top-8 logits and their ids, the
logsumexp, the greedy token and the top-2 margin, and digests of the
weights and the prompt.

It also keeps, for each compared token (a request's last prompt
position, each decode step's tokens) in each layer, the router's
decision and its margin: the k experts chosen (best first), which of
them kept a capacity slot, and the gap between the k-th and (k+1)-th
gate.  They come from a second pass over the same inputs, layer by layer
with the JAX package's own functions (``layers.attn_apply``,
``attn_decode``, ``rms_norm``, ``moe.moe_apply``, and the routing lines
of ``moe.moe_apply``), whose logits must agree with the model's.  A gate
gap under ``chip_smoke.py``'s ROUTE_GAP can flip an expert between XLA's
and the card's bf16 activations; the check leaves such a request (or
decode step) out and counts it.

Usage:  PYTHONPATH=src python tests/torch_granite_moe_regen.py   (~1 min)
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import layers as L
from repro.models import moe
from repro.models.model import build
from repro_torch.models.model import F32_LEAVES, numpy_params, tree_sha256

SEED = 0
N_LAYERS = 2
BATCH, PROMPT, CACHE, STEPS, TOP = 2, 256, 384, 4, 8
OUT = os.path.join(os.path.dirname(__file__), "golden",
                   "torch_granite_moe_fullwidth.json")


def jax_params(tree, cfg):
    """The numpy tree as JAX arrays: norm scales and the router float32,
    the rest in cfg.dtype (the dtypes repro.models initialises them
    in)."""
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


def routes(p, x, cfg):
    """The routing of ``moe.moe_apply`` (its lines, src/repro/models/
    moe.py:36-61) for x [B,S,D]: per token, the experts chosen [T,k],
    which kept a slot [T,k], and the k-th minus (k+1)-th gate [T]."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    M = min(moe.GROUP, B * S)
    G = B * S // M
    C = min(max(int(cfg.capacity_factor * M * k / E), 1), M)
    gates = jax.nn.softmax(
        L.einsum_f32("gmd,de->gme", x.reshape(G, M, D).astype(jnp.float32),
                     p["router"]), -1)
    topv, topi = jax.lax.top_k(gates, k + 1)
    onehot = jax.nn.one_hot(topi[..., :k], E, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(G, M * k, E), axis=1)
    pos = ((pos.reshape(G, M, k, E) * onehot - 1.0) * onehot).sum(-1)
    return (topi[..., :k].reshape(B * S, k), (pos < C).reshape(B * S, k),
            (topv[..., k - 1] - topv[..., k]).reshape(B * S))


def layer(params, i):
    return jax.tree.map(lambda a: a[i], params["layers"])


def walk_prefill(params, cfg, tokens, rows):
    """Prefill layer by layer; the routes of the tokens at flat indices
    ``rows`` in each layer, and the last logits."""
    B, S = tokens.shape
    x = L.embed_apply(params["embed"], tokens)
    positions = jnp.broadcast_to(jnp.arange(S)[None, :], (B, S))
    out = []
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        h = L.rms_norm(lp["ln1"], x, cfg.norm_eps)
        a, _ = L.attn_apply(lp["attn"], cfg, h, positions, window=cfg.window)
        x = x + a
        h = L.rms_norm(lp["ln2"], x, cfg.norm_eps)
        out.append([r[rows] for r in routes(lp["ffn"], h, cfg)])
        x = x + moe.moe_apply(lp["ffn"], h, cfg)
    x = L.rms_norm(params["ln_f"], x, cfg.norm_eps)
    return out, L.logits_apply(params["embed"], x[:, -1:])


def walk_decode(params, cfg, cache, tokens, pos):
    """One decode step layer by layer on a copy of the cache; the routes
    of its B tokens in each layer, and its logits."""
    x = L.embed_apply(params["embed"], tokens)
    out = []
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        h = L.rms_norm(lp["ln1"], x, cfg.norm_eps)
        a, _, _ = L.attn_decode(lp["attn"], cfg, h, pos, cache["k"][i],
                                cache["v"][i], window=cfg.window)
        x = x + a
        h = L.rms_norm(lp["ln2"], x, cfg.norm_eps)
        out.append(routes(lp["ffn"], h, cfg))
        x = x + moe.moe_apply(lp["ffn"], h, cfg)
    x = L.rms_norm(params["ln_f"], x, cfg.norm_eps)
    return out, L.logits_apply(params["embed"], x)


def route_record(per_layer) -> dict:
    """[layer] of (topi [B,k], keep [B,k], gap [B]) -> per request, per
    layer lists."""
    per_layer = [[np.asarray(a) for a in r] for r in per_layer]
    return {"route_topi": [[r[0][b].tolist() for r in per_layer]
                           for b in range(BATCH)],
            "route_keep": [[r[1][b].tolist() for r in per_layer]
                           for b in range(BATCH)],
            "route_gap": [[float(r[2][b]) for r in per_layer]
                          for b in range(BATCH)]}


def main():
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              n_layers=N_LAYERS)
    tree = numpy_params(cfg, SEED)
    prompt = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    m = build(cfg)
    params = jax_params(tree, cfg)
    logits, pc = jax.jit(m.prefill)(params, {"tokens": jnp.asarray(prompt)})
    rows = np.arange(BATCH) * PROMPT + PROMPT - 1
    per_layer, wl = jax.jit(walk_prefill, static_argnums=(1,))(
        params, cfg, jnp.asarray(prompt), rows)
    walk_err = float(jnp.max(jnp.abs(wl - logits)))
    steps = [dict(summary(logits[:, -1]), **route_record(per_layer))]
    cache = m.init_cache(BATCH, CACHE)
    cache = {k: cache[k].at[:, :, :PROMPT].set(pc[k].astype(cache[k].dtype))
             for k in cache}
    decode = jax.jit(m.decode_step)
    walk = jax.jit(walk_decode, static_argnums=(1,))
    tok = np.asarray(steps[-1]["token"], np.int32)[:, None]
    for i in range(STEPS):
        pos = jnp.full((BATCH,), PROMPT + i, jnp.int32)
        per_layer, wl = walk(params, cfg, cache, jnp.asarray(tok), pos)
        logits, cache = decode(params, cache, jnp.asarray(tok), pos)
        walk_err = max(walk_err, float(jnp.max(jnp.abs(wl - logits))))
        steps.append(dict(summary(logits[:, -1]), **route_record(per_layer)))
        tok = np.asarray(steps[-1]["token"], np.int32)[:, None]
        print(f"[granite-moe] step {i}: tokens {steps[-1]['token']}, "
              f"smallest gate gap {min(map(min, steps[-1]['route_gap'])):.3g}",
              flush=True)
    print(f"[granite-moe] the layer-by-layer pass's logits lie {walk_err:.3g}"
          f" from the model's")
    if walk_err > 1e-2:
        raise AssertionError("the layer-by-layer pass does not reproduce "
                             "the model's logits")
    snap = {"config": cfg.name, "n_layers": N_LAYERS, "dtype": cfg.dtype,
            "seed": SEED, "batch": BATCH, "prompt_len": PROMPT,
            "cache_len": CACHE, "decode_steps": STEPS, "top": TOP,
            "top_k": cfg.top_k,
            "weights_sha256": tree_sha256(tree),
            "prompt_sha256": tree_sha256({}, prompt),
            "walk_max_abs_err": walk_err, "steps": steps}
    with open(OUT, "w") as f:
        json.dump(snap, f, indent=1)
        f.write("\n")
    print(f"[granite-moe] wrote {OUT}")


if __name__ == "__main__":
    main()
