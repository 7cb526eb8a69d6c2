"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX
package's.

Seeded numpy trees go through both ``update``s: the reference's as a
pytree (layers stacked on axis 0), the port's as the same leaves under
its module names (each layer its own tensor).  Tolerance: 4e-6 relative
on parameters and moments, a few float32 ulps (the two sum the global
norm's squares in other orders, and XLA fuses the update's element-wise
chain where torch rounds after each operation; measured 9.3e-7 over
these cases); the step and the decay rule are exact.
The reference's three optimizer tests of ``tests/test_substrates.py``
are repeated on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as J
from repro_torch.optim import adamw as T

RTOL = 4e-6

# (JAX path, per-layer shape): two layers of a stack, a stacked norm
# scale ([L, d] in JAX, decayed there), per-head vectors, an unstacked
# matrix and an unstacked norm scale (not decayed)
LAYERS = 2
LEAVES = {("layers", "ln1", "scale"): (8,),
          ("layers", "attn", "wq"): (8, 12),
          ("layers", "mixer", "A_log"): (4,),
          ("embed", "tok"): (16, 8),
          ("ln_f", "scale"): (8,)}


def trees(seed, dtype, grad_scale=1.0):
    """(JAX params, JAX grads, port params, port grads) from one rng."""
    rng = np.random.default_rng(seed)
    jp, jg, tp, tg = {}, {}, {}, {}
    for path, shape in LEAVES.items():
        stacked = path[0] == "layers"
        full = ((LAYERS,) if stacked else ()) + shape
        p = rng.standard_normal(full).astype(np.float32)
        g = (rng.standard_normal(full) * grad_scale).astype(np.float32)
        for tree, a in ((jp, p), (jg, g)):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = jnp.asarray(a, dtype)
        names = ([f"{path[0]}.{i}.{'.'.join(path[1:])}" for i in
                  range(LAYERS)] if stacked else [".".join(path)])
        for i, n in enumerate(names):
            tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
            tp[n] = torch.from_numpy(p[i] if stacked else p).to(tdt)
            tg[n] = torch.from_numpy(g[i] if stacked else g).to(tdt)
    return jp, jg, tp, tg


def as_jax_layout(tensors):
    """A port name -> tensor dict in the JAX layout, float32 numpy."""
    out = {}
    for path, shape in LEAVES.items():
        if path[0] == "layers":
            a = np.stack([tensors[f"layers.{i}.{'.'.join(path[1:])}"]
                          .float().numpy() for i in range(LAYERS)])
        else:
            a = tensors[".".join(path)].float().numpy()
        out[path] = a
    return out


def jleaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(jnp.asarray(tree, jnp.float32))


def close(got, want, what):
    err = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-3))
    assert err <= RTOL, (what, err)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["unclipped", "clipped"])
def test_update_matches_reference(dtype, grad_scale):
    cfg = J.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    tcfg = T.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    jp, _, tp, _ = trees(0, dtype)
    js, ts = J.init(jp), T.init(tp)
    for step in range(3):
        _, jg, _, tg = trees(step + 1, dtype, grad_scale)
        jp, js, jm = J.update(cfg, jg, js, jp)
        tp, ts, tm = T.update(tcfg, tg, ts, tp)
        assert int(ts.step) == int(js.step) == step + 1
        close(tm["lr"].numpy(), np.asarray(jm["lr"]), "lr")
        close(tm["grad_norm"].numpy(), np.asarray(jm["grad_norm"]),
              "grad_norm")
        if grad_scale > 1:
            assert float(tm["grad_norm"]) > tcfg.clip_norm
        for tree, jtree in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            for path, a in as_jax_layout(tree).items():
                close(a, jleaf(jtree, path), path)
        for n, t in tp.items():
            assert t.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                               else torch.float32), n
            assert ts.mu[n].dtype == torch.float32


def test_decay_follows_the_jax_rank():
    """A layer's norm scale ([d] in the port, [L, d] in JAX) and per-head
    vectors decay; ln_f's scale does not: with zero gradients the update
    is the decay alone."""
    cfg = T.AdamWConfig(lr=0.5, warmup_steps=0, weight_decay=0.1)
    _, _, tp, _ = trees(0, jnp.float32)
    zeros = {n: torch.zeros_like(t) for n, t in tp.items()}
    new, _, _ = T.update(cfg, zeros, T.init(tp), tp)
    want = {"layers.0.ln1.scale": True, "layers.1.attn.wq": True,
            "layers.1.mixer.A_log": True, "embed.tok": True,
            "ln_f.scale": False}
    for n, decays in want.items():
        assert T.decays(n, tp[n]) == decays, n
        moved = not torch.equal(new[n], tp[n])
        assert moved == decays, n


def test_adamw_minimizes_quadratic():
    cfg = T.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                        total_steps=200, clip_norm=10.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    st = T.init(params)
    for _ in range(150):
        g = {"x": 2 * params["x"]}
        params, st, _ = T.update(cfg, g, st, params)
    assert float(torch.max(torch.abs(params["x"]))) < 0.1


def test_adamw_clips():
    cfg = T.AdamWConfig(clip_norm=1.0)
    params = {"x": torch.zeros(3)}
    st = T.init(params)
    g = {"x": torch.tensor([100.0, 0.0, 0.0])}
    _, _, m = T.update(cfg, g, st, params)
    assert float(m["grad_norm"]) == pytest.approx(100.0)


def test_schedule_warmup_and_decay():
    cfg = T.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    assert float(T.schedule(cfg, 5)) == pytest.approx(0.5)
    assert float(T.schedule(cfg, torch.tensor(10, dtype=torch.int32))) \
        == pytest.approx(1.0)
    end = float(T.schedule(cfg, 100))
    assert end == pytest.approx(0.1, abs=1e-3)
    jcfg = J.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    for s in (0, 3, 10, 37, 99, 100, 250):
        assert float(T.schedule(cfg, s)) == pytest.approx(
            float(J.schedule(jcfg, jnp.int32(s))), rel=1e-6), s


def test_update_leaves_its_inputs_alone():
    cfg = T.AdamWConfig()
    _, _, tp, tg = trees(0, jnp.float32)
    st = T.init(tp)
    before = {n: t.clone() for n, t in tp.items()}
    T.update(cfg, tg, st, tp)
    assert int(st.step) == 0 and all(float(m.abs().max()) == 0
                                     for m in st.mu.values())
    assert all(torch.equal(before[n], tp[n]) for n in tp)
