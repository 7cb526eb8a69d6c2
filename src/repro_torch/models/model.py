"""Unified model API, the port of ``repro.models.model`` for the dense
and ssm families: ``build(cfg)`` -> ``Model`` with init / forward /
init_cache / prefill / decode_step.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; with no card and no CPU request they raise.  Other
families (moe, hybrid, encdec, vlm) raise, naming the ROADMAP queue that
brings them.

Parameters cross between the packages as the JAX pytree of numpy arrays
(layers stacked on axis 0, as the reference's ``init`` vmaps them):
``params_from_jax`` builds the port's ``Transformer`` or ``SSM`` from
one, ``params_to_numpy`` gives it back (bf16 leaves as numpy's bfloat16,
which needs ml_dtypes, as jax has it).  ``numpy_params`` draws such a
tree from a numpy seed, and ``tree_sha256`` digests it, for the
full-width snapshots that ``tests/torch_granite_regen.py`` and
``tests/torch_mamba2_regen.py`` make with the JAX package and
``chip_smoke.py`` checks the port against.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mmu import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm, transformer
from repro_torch.models.transformer import TOKENS_PER_PAGE

__all__ = ["F32_LEAVES", "Model", "build", "cross_entropy", "dummy_batch",
           "numpy_params", "param_shapes", "params_from_jax",
           "params_to_numpy", "tree_sha256"]

_FAMILY = {"dense": transformer, "ssm": ssm}

# leaves the reference keeps in float32 whatever the config's dtype
F32_LEAVES = ("scale", "conv_b", "dt_bias", "A_log", "Dskip")


def cross_entropy(logits, targets, mask=None):
    """Token CE in float32. logits [B,S,V], targets [B,S] int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


class Model:
    """A ModelConfig bound to its family's implementation, on one device.
    ``page`` is the dense family's decode attention page size (the cache
    length must be a multiple of it)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 page: int = TOKENS_PER_PAGE):
        L.check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.page = int(page)
        self._impl = _FAMILY[cfg.family]

    def init(self, generator: torch.Generator):
        """Random parameters drawn from ``generator`` on the model's
        device (the generator must live there)."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"the generator is on {generator.device}, the "
                             f"model on {self.device}")
        with torch.no_grad():
            return self._impl.init(generator, self.cfg)

    def forward(self, params, batch):
        return self._impl.forward(params, self.cfg,
                                  batch["tokens"].to(self.device))

    def init_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16):
        return self._impl.init_cache(self.cfg, batch, seq_len, dtype,
                                     self.device)

    def prefill(self, params, batch, cache=None):
        """Returns (logits of the last position, cache).  Dense: see
        ``transformer.prefill`` (a given cache is filled in place).  ssm:
        the cache is None, as the reference returns it; decode starts
        from ``init_cache``."""
        tokens = batch["tokens"].to(self.device)
        if self.cfg.family == "ssm":
            if cache is not None:
                raise ValueError("the ssm prefill fills no cache (the "
                                 "reference's returns none)")
            return ssm.prefill(params, self.cfg, tokens)
        return transformer.prefill(params, self.cfg, tokens, cache)

    def decode_step(self, params, cache, tokens, pos):
        """Returns (logits [B,1,V], cache), the cache updated in place.
        The ssm family ignores ``pos``, as the reference does."""
        tokens = tokens.to(self.device)
        if self.cfg.family == "ssm":
            return ssm.decode_step(params, self.cfg, cache, tokens)
        return transformer.decode_step(params, self.cfg, cache, tokens,
                                       pos.to(self.device), page=self.page)


def build(cfg: ModelConfig, device=None, page: int = TOKENS_PER_PAGE):
    return Model(cfg, device, page)


def dummy_batch(cfg: ModelConfig, batch: int, seq: int,
                generator: torch.Generator):
    """Random tokens [batch, seq] (int32) drawn from ``generator``."""
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=generator,
                         device=generator.device, dtype=torch.int32)
    return {"tokens": toks}


# ------------------------------------------------ crossing between packages


def param_shapes(cfg: ModelConfig) -> dict:
    """Path -> shape of every leaf of the JAX parameter pytree of a dense
    or ssm model (layers stacked on axis 0), paths in sorted order."""
    L.check_ported(cfg)
    D, V, n = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    s = {("embed", "tok"): (V, D), ("ln_f", "scale"): (D,)}
    if not cfg.tie_embeddings:
        s[("embed", "head")] = (D, V)
    if cfg.family == "ssm":
        di, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        conv_dim = di + 2 * G * N
        per = {("ln", "scale"): (D,),
               ("mixer", "in_proj"): (D, 2 * di + 2 * G * N + H),
               ("mixer", "conv_w"): (cfg.ssm_conv, conv_dim),
               ("mixer", "conv_b"): (conv_dim,), ("mixer", "dt_bias"): (H,),
               ("mixer", "A_log"): (H,), ("mixer", "Dskip"): (H,),
               ("mixer", "norm", "scale"): (di,),
               ("mixer", "out_proj"): (di, D)}
    else:
        F, H, K, hd = cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        per = {("attn", "wq"): (D, H * hd), ("attn", "wk"): (D, K * hd),
               ("attn", "wv"): (D, K * hd), ("attn", "wo"): (H * hd, D),
               ("ffn", "wi"): (D, F), ("ffn", "wg"): (D, F),
               ("ffn", "wo"): (F, D), ("ln1", "scale"): (D,),
               ("ln2", "scale"): (D,)}
    for path, shape in per.items():
        s[("layers",) + path] = (n,) + shape
    return dict(sorted(s.items()))


def _leaf_dtype(path, cfg: ModelConfig) -> torch.dtype:
    """Norm scales and the SSM's per-head and bias vectors are float32,
    every matrix is in the config's dtype (as ``repro.models`` initialises
    them)."""
    return torch.float32 if path[-1] in F32_LEAVES else L.dtype_of(cfg)


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A copy of numpy array ``a`` (bf16 arrays included) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """bf16 tensors come back as numpy's bfloat16, which exists once
    ml_dtypes is loaded (jax loads it)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def params_from_jax(tree, cfg: ModelConfig, device=None):
    """The port's parameters (``Transformer`` or ``SSM``) from the JAX
    pytree of numpy arrays.

    Every leaf is copied (never shared with the caller's buffer) and cast
    to the dtype ``repro.models`` gives it (``_leaf_dtype``).  Raises on a
    missing or extra leaf or a shape that is not the config's."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    got = _flatten(tree)
    if set(got) != set(shapes):
        raise ValueError(f"the pytree's leaves {sorted(set(got) ^ set(shapes))}"
                         f" do not match {cfg.name}'s")
    for path, shape in shapes.items():
        if tuple(np.shape(got[path])) != shape:
            raise ValueError(f"{'/'.join(path)} has shape "
                             f"{tuple(np.shape(got[path]))}, want {shape}")

    def mod(cls, sub, i=None, **kw):
        return cls(**kw, **{path[-1]: _tensor(a if i is None else a[i],
                                              _leaf_dtype(path, cfg), dev)
                            for path, a in got.items() if path[:-1] == sub})

    embed, ln_f = mod(L.Embed, ("embed",)), mod(L.RMSNorm, ("ln_f",))
    if cfg.family == "ssm":
        blocks = [ssm.Block(
            ln=mod(L.RMSNorm, ("layers", "ln"), i),
            mixer=mod(ssm.Mixer, ("layers", "mixer"), i,
                      norm=mod(L.RMSNorm, ("layers", "mixer", "norm"), i)))
            for i in range(cfg.n_layers)]
        return ssm.SSM(embed=embed, layers=blocks, ln_f=ln_f)
    blocks = [transformer.Block(
        ln1=mod(L.RMSNorm, ("layers", "ln1"), i),
        attn=mod(L.Attention, ("layers", "attn"), i),
        ln2=mod(L.RMSNorm, ("layers", "ln2"), i),
        ffn=mod(L.MLP, ("layers", "ffn"), i)) for i in range(cfg.n_layers)]
    return transformer.Transformer(embed=embed, layers=blocks, ln_f=ln_f)


def params_to_numpy(params) -> dict:
    """The JAX pytree of numpy arrays (layers stacked on axis 0)."""
    tree, per_layer = {}, {}
    for name, p in params.named_parameters():
        path = tuple(name.split("."))
        if path[0] == "layers":
            per_layer.setdefault(("layers",) + path[2:], []).append(_numpy(p))
            continue
        tree.setdefault(path[0], {})[path[1]] = _numpy(p)
    for path, leaves in per_layer.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.stack(leaves)
    return tree


def _draw(rng, path, shape) -> np.ndarray:
    """One leaf of ``numpy_params``."""
    if path[-1] in ("scale", "Dskip"):
        return np.ones(shape, np.float32)
    if path[-1] == "conv_b":
        return np.zeros(shape, np.float32)
    if path[-1] == "A_log":
        return np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
    if path[-1] == "dt_bias":
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
        return (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    a = rng.standard_normal(shape, dtype=np.float32)
    if path[-1] == "conv_w":
        return a * np.float32(0.1)
    fan_in = shape[1] if path[0] == "layers" else shape[0]
    a *= np.float32(1.0 / np.sqrt(fan_in))
    return a


def numpy_params(cfg: ModelConfig, seed: int) -> dict:
    """A JAX-shaped parameter pytree of float32 numpy arrays drawn from
    ``numpy.random.default_rng(seed)`` leaf by leaf in sorted path order:
    norm scales and Dskip 1, conv_b 0, conv_w 0.1-normal, every other
    matrix normal(0, 1/fan_in) with fan_in its first per-layer axis.
    A_log and dt_bias follow Mamba-2's published init (A = -exp(A_log)
    uniform in [-16, -1]; softplus(dt_bias) log-uniform in [1e-3, 1e-1]),
    where the reference's init has zeros, so that a chunk's decay sums
    reach the kernel's clip at -60.  Both packages cast the matrices to
    ``cfg.dtype`` on loading."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, shape in param_shapes(cfg).items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _draw(rng, path, shape)
    return tree


def tree_sha256(tree, *extra: np.ndarray) -> str:
    """sha256 over every leaf's bytes in sorted path order, then over
    each of ``extra`` (e.g. the prompt tokens)."""
    h = hashlib.sha256()
    for path, a in _flatten(tree).items():
        h.update("/".join(path).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    for a in extra:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()
