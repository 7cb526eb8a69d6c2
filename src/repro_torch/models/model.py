"""Unified model API, the port of ``repro.models.model``: ``build(cfg)``
-> ``Model`` with init / forward / loss / init_cache / prefill /
decode_step,
for every family of the reference (dense, moe and vlm through
``transformer``, encdec through ``encdec``, ssm through ``ssm``, hybrid
through ``rglru``).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; with no card and no CPU request they raise.

Parameters cross between the packages as the JAX pytree of numpy arrays
(layers stacked on axis 0, as the reference's ``init`` vmaps them; the
encoder's and decoder's under ``enc`` and ``dec``, the hybrid's
superblocks and tail under ``super`` and ``tail``): ``params_from_jax``
builds the port's ``Transformer``, ``EncDec``, ``SSM`` or ``Hybrid``
from one, ``params_to_numpy`` gives it back (bf16 leaves as numpy's bfloat16,
which needs ml_dtypes, as jax has it).  ``numpy_params`` draws such a
tree from a numpy seed, and ``tree_sha256`` digests it, for the
full-width snapshots that the ``tests/torch_*_regen.py`` scripts make
with the JAX package and ``chip_smoke.py`` checks the port against.
"""
from __future__ import annotations

import copy
import hashlib

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mmu import resolve_device
from repro_torch.models import encdec, moe, rglru, ssm, transformer
from repro_torch.models import layers as L
from repro_torch.models.transformer import TOKENS_PER_PAGE

__all__ = ["F32_LEAVES", "Model", "build", "cross_entropy", "dummy_batch",
           "jax_layout", "jax_path", "named_tensors", "numpy_params",
           "param_shapes", "params_from_jax", "params_to_numpy",
           "tree_sha256", "with_tensors"]

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "encdec": encdec, "ssm": ssm, "hybrid": rglru}


def _impl_of(cfg: ModelConfig):
    """The module that implements ``cfg``'s family; raises on a family
    that is none of the reference's."""
    if cfg.family not in _FAMILY:
        raise ValueError(f"{cfg.name}: unknown model family {cfg.family!r}; "
                         f"the families are {tuple(_FAMILY)}")
    return _FAMILY[cfg.family]


# leaves the reference keeps in float32 whatever the config's dtype
F32_LEAVES = ("scale", "conv_b", "dt_bias", "A_log", "Dskip", "router",
              "ba", "bx", "a_param")

# the pytree's stacks of layers (axis 0 the layer)
STACKS = ("layers", "enc", "dec", "super", "tail")

# families whose prefill fills no cache (the reference's returns none)
STATELESS_PREFILL = ("ssm", "encdec", "hybrid")


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
    ``page`` is the decode attention's page size (the cache length must
    be a multiple of it)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 page: int = TOKENS_PER_PAGE):
        self._impl = _impl_of(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.page = int(page)

    def init(self, generator: torch.Generator):
        """Random parameters drawn from ``generator`` on the model's
        device (the generator must live there)."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"the generator is on {generator.device}, the "
                             f"model on {self.device}")
        with torch.no_grad():
            return self._impl.init(generator, self.cfg)

    def _extras(self, batch) -> dict:
        """The transformer's stub inputs in a batch: M-RoPE's
        ``positions3`` and the vision embeddings."""
        out = {}
        for key, arg in (("positions3", "positions3"),
                         ("vision_embeds", "input_embeds")):
            if batch.get(key) is not None:
                out[arg] = batch[key].to(self.device)
        return out

    def forward(self, params, batch, remat: bool = True):
        """Logits [B,S,V] (float32).  Under autograd with ``remat``, each
        layer (each superblock for the hybrid) keeps only its input and
        recomputes the rest in the backward pass, as the reference's
        ``jax.checkpoint(..., nothing_saveable)``; it changes no
        value."""
        cfg, tokens = self.cfg, batch["tokens"].to(self.device)
        if cfg.family in ("ssm", "hybrid"):
            return self._impl.forward(params, cfg, tokens, remat=remat)
        if cfg.family == "encdec":
            src = batch["src_embeds"].to(self.device, L.dtype_of(cfg))
            return encdec.forward(params, cfg, tokens, src, remat=remat)
        return transformer.forward(params, cfg, tokens, remat=remat,
                                   **self._extras(batch))

    def loss(self, params, batch, remat: bool = True):
        """Next-token cross-entropy of ``forward``'s logits[:, :-1]
        against tokens[:, 1:] (``loss_mask`` [B,S-1] weighs the
        positions), plus, for moe, 0.01 times layer 0's router balance
        loss on the embedding stream, as the reference's ``Model.loss``."""
        logits = self.forward(params, batch, remat)
        tokens = batch["tokens"].to(self.device)
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = mask.to(self.device, torch.float32)
        lv = cross_entropy(logits[:, :-1], tokens[:, 1:], mask)
        if self.cfg.family == "moe":
            x = L.embed_apply(params.embed, tokens)
            lv = lv + 0.01 * moe.aux_loss(params.layers[0].ffn, x, self.cfg)
        return lv

    def init_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16):
        return self._impl.init_cache(self.cfg, batch, seq_len, dtype,
                                     self.device)

    def prefill(self, params, batch, cache=None):
        """Returns (logits of the last position, cache).  dense, moe and
        vlm: see ``transformer.prefill`` (a given cache is filled in
        place).  ssm, encdec and hybrid: the cache is None, as the
        reference returns it (encdec's prefill is its forward's last
        logits); decode starts from ``init_cache``."""
        cfg = self.cfg
        if cfg.family in STATELESS_PREFILL:
            if cache is not None:
                raise ValueError(f"the {cfg.family} prefill fills no cache "
                                 f"(the reference's returns none)")
            if cfg.family == "encdec":
                return self.forward(params, batch, remat=False)[:, -1:], None
            return self._impl.prefill(params, cfg,
                                      batch["tokens"].to(self.device))
        return transformer.prefill(params, cfg,
                                   batch["tokens"].to(self.device), cache,
                                   **self._extras(batch))

    def decode_step(self, params, cache, tokens, pos, extras=None):
        """Returns (logits [B,1,V], cache), the cache updated in place.
        The ssm family ignores ``pos``, as the reference does.
        ``extras``: ``positions3`` [3,B,1] for M-RoPE; a vlm step without
        them uses the text positions (t = h = w = pos), as the
        reference."""
        cfg, tokens = self.cfg, tokens.to(self.device)
        if cfg.family == "ssm":
            return ssm.decode_step(params, cfg, cache, tokens)
        pos = pos.to(self.device)
        if cfg.family in ("encdec", "hybrid"):
            return self._impl.decode_step(params, cfg, cache, tokens, pos,
                                          page=self.page)
        positions3 = (extras or {}).get("positions3")
        if positions3 is not None:
            positions3 = positions3.to(self.device)
        elif cfg.family == "vlm":
            positions3 = torch.stack([pos[:, None]] * 3)
        return transformer.decode_step(params, cfg, cache, tokens, pos,
                                       page=self.page, positions3=positions3)


def build(cfg: ModelConfig, device=None, page: int = TOKENS_PER_PAGE):
    return Model(cfg, device, page)


def dummy_batch(cfg: ModelConfig, batch: int, seq: int,
                generator: torch.Generator):
    """Random tokens [batch, seq] (int32) drawn from ``generator``, and
    the family's stub inputs: vlm ``vision_embeds`` [batch, P, D] (P =
    min(n_patches, seq // 2)) and ``positions3`` [3, batch, seq] (the
    text positions in all three streams); encdec ``src_embeds`` [batch,
    seq, D].  The embeddings are normal draws times 0.02 in the config's
    dtype (the reference's vision stub is zeros)."""
    dev = generator.device
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=generator,
                         device=dev, dtype=torch.int32)
    out = {"tokens": toks}

    def embeds(n):
        return (torch.randn((batch, n, cfg.d_model), generator=generator,
                            device=dev) * 0.02).to(L.dtype_of(cfg))
    if cfg.family == "vlm":
        out["vision_embeds"] = embeds(min(cfg.n_patches, seq // 2))
        pos = torch.arange(seq, dtype=torch.int32, device=dev)
        out["positions3"] = pos[None, None, :].expand(3, batch, seq)
    if cfg.family == "encdec":
        out["src_embeds"] = embeds(seq)
    return out


# ------------------------------------------------ crossing between packages


def _attn_shapes(cfg: ModelConfig) -> dict:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {("wq",): (D, H * hd), ("wk",): (D, K * hd), ("wv",): (D, K * hd),
         ("wo",): (H * hd, D)}
    if cfg.qk_norm:
        s.update({("q_norm", "scale"): (hd,), ("k_norm", "scale"): (hd,)})
    return s


def _ffn_shapes(cfg: ModelConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.family == "moe":
        E = cfg.n_experts
        return {("router",): (D, E), ("wi",): (E, D, F), ("wg",): (E, D, F),
                ("wo",): (E, F, D)}
    return {("wi",): (D, F), ("wg",): (D, F), ("wo",): (F, D)}


def param_shapes(cfg: ModelConfig) -> dict:
    """Path -> shape of every leaf of the JAX parameter pytree (layers
    stacked on axis 0), paths in sorted order."""
    _impl_of(cfg)
    D, V = cfg.d_model, cfg.padded_vocab
    s = {("embed", "tok"): (V, D), ("ln_f", "scale"): (D,)}
    if not cfg.tie_embeddings:
        s[("embed", "head")] = (D, V)

    def sub(name, shapes):
        return {(name,) + path: shape for path, shape in shapes.items()}

    norm = {("scale",): (D,)}
    if cfg.family == "hybrid":
        W, nb = rglru.lru_width(cfg), rglru.N_GATE_BLOCKS
        mlp = _ffn_shapes(cfg)
        rec = {("wxin",): (D, W), ("wgate",): (D, W), ("conv_w",): (4, W),
               ("conv_b",): (W,), ("wout",): (W, D),
               ("lru", "wa"): (nb, W // nb, W // nb), ("lru", "ba"): (W,),
               ("lru", "wx"): (nb, W // nb, W // nb), ("lru", "bx"): (W,),
               ("lru", "a_param"): (W,), **sub("ln1", norm),
               **sub("ln2", norm), **sub("mlp", mlp)}
        att = {**sub("attn", _attn_shapes(cfg)), **sub("ln1", norm),
               **sub("ln2", norm), **sub("mlp", mlp)}
        n_super, tail = rglru.layout(cfg)
        stacks = {"super": (n_super, {**sub("rec1", rec), **sub("rec2", rec),
                                      **sub("attn", att)})}
        if tail:
            stacks["tail"] = (tail, rec)
    elif cfg.family == "ssm":
        di, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        conv_dim = di + 2 * G * N
        stacks = {"layers": (cfg.n_layers, {
            ("ln", "scale"): (D,),
            ("mixer", "in_proj"): (D, 2 * di + 2 * G * N + H),
            ("mixer", "conv_w"): (cfg.ssm_conv, conv_dim),
            ("mixer", "conv_b"): (conv_dim,), ("mixer", "dt_bias"): (H,),
            ("mixer", "A_log"): (H,), ("mixer", "Dskip"): (H,),
            ("mixer", "norm", "scale"): (di,),
            ("mixer", "out_proj"): (di, D)})}
    elif cfg.family == "encdec":
        s[("enc_ln", "scale")] = (D,)
        mlp = _ffn_shapes(cfg)
        enc = {**sub("attn", _attn_shapes(cfg)), **sub("ln1", norm),
               **sub("ln2", norm), **sub("mlp", mlp)}
        dec = {**enc, **sub("cross", _attn_shapes(cfg)), **sub("lnx", norm)}
        stacks = {"enc": (cfg.n_enc_layers, enc), "dec": (cfg.n_layers, dec)}
    else:
        stacks = {"layers": (cfg.n_layers, {
            **sub("attn", _attn_shapes(cfg)), **sub("ffn", _ffn_shapes(cfg)),
            **sub("ln1", norm), **sub("ln2", norm)})}
    for name, (n, per) in stacks.items():
        for path, shape in per.items():
            s[(name,) + path] = (n,) + shape
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
    """The port's parameters (``Transformer``, ``EncDec``, ``SSM`` or
    ``Hybrid``) from the JAX pytree of numpy arrays.

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

    def attn(sub, i):
        norms = {}
        if cfg.qk_norm:
            norms = {n: mod(L.RMSNorm, sub + (n,), i)
                     for n in ("q_norm", "k_norm")}
        return mod(L.Attention, sub, i, **norms)

    def norm(*sub, i=None):
        return mod(L.RMSNorm, sub, i)

    embed, ln_f = mod(L.Embed, ("embed",)), norm("ln_f")
    if cfg.family == "hybrid":
        def rec(*sub, i):
            return mod(rglru.RecBlock, sub, i, ln1=norm(*sub, "ln1", i=i),
                       lru=mod(rglru.RGLRU, sub + ("lru",), i),
                       ln2=norm(*sub, "ln2", i=i),
                       mlp=mod(L.MLP, sub + ("mlp",), i))

        n_super, tail = rglru.layout(cfg)
        supers = [rglru.Super(
            rec1=rec("super", "rec1", i=i), rec2=rec("super", "rec2", i=i),
            attn=rglru.AttnBlock(
                ln1=norm("super", "attn", "ln1", i=i),
                attn=attn(("super", "attn", "attn"), i),
                ln2=norm("super", "attn", "ln2", i=i),
                mlp=mod(L.MLP, ("super", "attn", "mlp"), i)))
            for i in range(n_super)]
        return rglru.Hybrid(embed=embed, super_=supers,
                            tail=[rec("tail", i=i) for i in range(tail)],
                            ln_f=ln_f)
    if cfg.family == "ssm":
        blocks = [ssm.Block(
            ln=norm("layers", "ln", i=i),
            mixer=mod(ssm.Mixer, ("layers", "mixer"), i,
                      norm=norm("layers", "mixer", "norm", i=i)))
            for i in range(cfg.n_layers)]
        return ssm.SSM(embed=embed, layers=blocks, ln_f=ln_f)
    if cfg.family == "encdec":
        enc = [encdec.EncBlock(
            ln1=norm("enc", "ln1", i=i), attn=attn(("enc", "attn"), i),
            ln2=norm("enc", "ln2", i=i), mlp=mod(L.MLP, ("enc", "mlp"), i))
            for i in range(cfg.n_enc_layers)]
        dec = [encdec.DecBlock(
            ln1=norm("dec", "ln1", i=i), attn=attn(("dec", "attn"), i),
            lnx=norm("dec", "lnx", i=i), cross=attn(("dec", "cross"), i),
            ln2=norm("dec", "ln2", i=i), mlp=mod(L.MLP, ("dec", "mlp"), i))
            for i in range(cfg.n_layers)]
        return encdec.EncDec(embed=embed, enc=enc, enc_ln=norm("enc_ln"),
                             dec=dec, ln_f=ln_f)
    ffn = L.MoE if cfg.family == "moe" else L.MLP
    blocks = [transformer.Block(
        ln1=norm("layers", "ln1", i=i), attn=attn(("layers", "attn"), i),
        ln2=norm("layers", "ln2", i=i), ffn=mod(ffn, ("layers", "ffn"), i))
        for i in range(cfg.n_layers)]
    return transformer.Transformer(embed=embed, layers=blocks, ln_f=ln_f)


def jax_path(name: str) -> tuple:
    """The JAX pytree path of the port's parameter ``name`` (a dotted
    ``named_parameters`` name) and its layer in the stack, or None where
    the reference stacks nothing: ``layers.3.ln1.scale`` -> (("layers",
    "ln1", "scale"), 3)."""
    parts = tuple(name.split("."))
    if parts[0] in STACKS and len(parts) > 2 and parts[1].isdigit():
        return (parts[0],) + parts[2:], int(parts[1])
    return parts, None


def jax_layout(names) -> dict:
    """JAX path -> the port's names of its leaf (a stack's in layer
    order), in the reference's leaf order (``jax.tree.flatten`` of a
    dict sorts its keys, which orders the paths lexicographically)."""
    out = {}
    for name in names:
        path, i = jax_path(name)
        out.setdefault(path, []).append((-1 if i is None else i, name))
    return {path: [n for _, n in sorted(out[path])] for path in sorted(out)}


def named_tensors(params) -> dict:
    """name -> tensor: a module's ``named_parameters``, or a dict as it
    is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def with_tensors(params, tensors: dict):
    """``params`` with each named tensor replaced by ``tensors[name]``: a
    new module of the same structure (no tensor copied; each parameter
    keeps its ``requires_grad``), or a new dict."""
    if isinstance(params, nn.Module):
        memo = {id(p): nn.Parameter(tensors[n], requires_grad=p.requires_grad)
                for n, p in params.named_parameters()}
        return copy.deepcopy(params, memo)
    return {n: tensors[n] for n in params}


def params_to_numpy(params) -> dict:
    """The JAX pytree of numpy arrays (layers stacked on axis 0)."""
    ps = named_tensors(params)
    tree = {}
    for path, names in jax_layout(ps).items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        leaves = [_numpy(ps[n]) for n in names]
        node[path[-1]] = (np.stack(leaves) if jax_path(names[0])[1] is not None
                          else leaves[0])
    return tree


def _draw(rng, path, shape) -> np.ndarray:
    """One leaf of ``numpy_params``."""
    if path[-1] in ("scale", "Dskip"):
        return np.ones(shape, np.float32)
    if path[-1] in ("conv_b", "ba", "bx"):
        return np.zeros(shape, np.float32)
    if path[-1] == "a_param":
        lam = rng.uniform(0.9, 0.999, shape)
        return np.log(np.expm1(-np.log(lam) / rglru.LRU_C)).astype(
            np.float32)
    if path[-1] == "A_log":
        return np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
    if path[-1] == "dt_bias":
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
        return (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    a = rng.standard_normal(shape, dtype=np.float32)
    if path[-1] == "conv_w":
        return a * np.float32(0.1)
    if path[0] not in STACKS:
        fan_in = shape[0]
    elif path[-1] in ("wa", "wx"):
        fan_in = shape[-2]    # the RG-LRU's diagonal blocks: W / 16
    elif path[-2] == "ffn" and len(shape) == 4:
        fan_in = shape[2]     # experts [n,E,D,F] / [n,E,F,D]: D or F
    else:
        fan_in = shape[1]
    a *= np.float32(1.0 / np.sqrt(fan_in))
    return a


def numpy_params(cfg: ModelConfig, seed: int) -> dict:
    """A JAX-shaped parameter pytree of float32 numpy arrays drawn from
    ``numpy.random.default_rng(seed)`` leaf by leaf in sorted path order:
    norm scales and Dskip 1, conv_b 0, conv_w 0.1-normal, every other
    matrix normal(0, 1/fan_in) with fan_in its first per-layer axis, but
    an expert tensor's its second (D for wi and wg, F for wo: the
    reference's ``in_axis=1``), and an RG-LRU gate block's its last but
    one (W / 16, the reference's ``_bdiag_init``).
    A_log and dt_bias follow Mamba-2's published init (A = -exp(A_log)
    uniform in [-16, -1]; softplus(dt_bias) log-uniform in [1e-3, 1e-1]),
    where the reference's init has zeros, so that a chunk's decay sums
    reach the kernel's clip at -60.  The RG-LRU's a_param follows the
    reference's init (a = exp(-8 softplus(a_param)) uniform in (0.9,
    0.999)), so that the recurrence remembers over tens of steps; its
    biases ba and bx are 0.  Both packages cast the matrices to
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
