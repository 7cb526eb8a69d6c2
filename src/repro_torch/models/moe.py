"""Mixture-of-Experts FFN (mixtral-8x7b, granite-moe-1b-a400m); the port
of ``repro.models.moe``.

Routing is the reference's, decision for decision (``route``): the B*S
tokens split into groups of M = min(GROUP, B*S); router logits in
float32 from ``x.float()``; softmax; the top k gates, the lower expert
first where two are equal (as ``lax.top_k``); the k gates divided by
their sum; each (token, choice) takes the next slot of its expert's
capacity C = max(int(capacity_factor * M * k / E), 1), at most M, in
(token, choice) order, so earlier tokens and choices win, and is dropped
past C.  A decode step routes its B tokens as one group: at
granite-moe-1b-a400m's B = 2, C = 1, and the second request loses every
expert the first one also picked.  Both packages do that on purpose.

The reference moves tokens with one-hot [G,M,E,C] einsums.  The port
gathers each expert's kept tokens into a buffer [E, G*C, D] (empty slots
zero, as the one-hot leaves them), runs the experts as three batched
products with float32 accumulation, and adds each slot's output, times
its gate, back to its token with ``index_add_`` in float32.  The
roundings are the reference's: the gathered rows in x's dtype; the gate
product kept in float32 through the SiLU, then cast; the input product
and the output product cast to x's dtype; the combine weights rounded to
x's dtype; the sum cast to x's dtype at the end.  Selection is exact
(the reference adds one row to zeros), so only the order of the <= k
terms of a token's sum differs.

``aux_loss`` is the reference's load-balancing loss, which
``Model.loss`` adds for training.  Under autograd the expert products
widen bf16 operands to float32 first (the CPU's form, the same sums):
the card's bf16-in, float32-out ``bmm`` has no backward.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

GROUP = 512  # tokens per routing group


class Routes(NamedTuple):
    """One ``moe_apply``'s routing over G groups of M tokens."""
    gates: torch.Tensor  # [G,M,E] float32: softmax of the router logits
    topi: torch.Tensor   # [G,M,k] int64: the chosen experts, best first
    topv: torch.Tensor   # [G,M,k] float32: their gates, divided by the sum
    pos: torch.Tensor    # [G,M,k] int64: each choice's slot in its expert
    keep: torch.Tensor   # [G,M,k] bool: pos < C (else the choice drops)
    C: int               # slots an expert has in a group


def groups(B: int, S: int) -> tuple[int, int]:
    """(G, M): the routing groups of B*S tokens and their size; raises
    where the reference's assertion fails (B*S above GROUP and not a
    multiple of it)."""
    T = B * S
    M = min(GROUP, T)
    if T % M:
        raise ValueError(f"{B} x {S} tokens do not split into routing "
                         f"groups of {M}")
    return T // M, M


def capacity(cfg: ModelConfig, M: int) -> int:
    """Slots per expert in a group of M tokens (the reference's
    arithmetic, Python's ``int()`` truncation included)."""
    C = max(int(cfg.capacity_factor * M * cfg.top_k / cfg.n_experts), 1)
    return min(C, M)


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> L.MoE:
    """Random experts drawn from ``gen``: normal(0, 1/fan_in) with fan_in
    D for the router, wi and wg and F for wo (``in_axis=1``, as the
    reference)."""
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    dt = L.dtype_of(cfg)
    return L.MoE(router=L.dense_init(gen, (D, E), dtype=torch.float32),
                 wi=L.dense_init(gen, (E, D, Fd), in_axis=1, dtype=dt),
                 wg=L.dense_init(gen, (E, D, Fd), in_axis=1, dtype=dt),
                 wo=L.dense_init(gen, (E, Fd, D), in_axis=1, dtype=dt))


def route(p, x, cfg: ModelConfig) -> Routes:
    """The reference's routing of x [B,S,D] (see the module's text)."""
    B, S, D = x.shape
    G, M = groups(B, S)
    E, k = cfg.n_experts, cfg.top_k
    logits = torch.matmul(x.reshape(G, M, D).float(), p.router)
    gates = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower expert first on ties
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # earlier (token, choice) pairs take an expert's slots first: a count
    # along the (token, choice) order, expert by expert (an innermost
    # scan: over the outer axis the card's scan took ~0.8 ms a layer at
    # 8 groups of 512 x 8 choices)
    onehot = F.one_hot(topi, E).reshape(G, M * k, E).transpose(1, 2)
    taken = torch.cumsum(onehot.to(torch.int32), dim=-1, dtype=torch.int32)
    pos = torch.gather(taken, 1, topi.reshape(G, 1, M * k)).reshape(
        G, M, k).long() - 1
    C = capacity(cfg, M)
    return Routes(gates, topi, topv, pos, pos < C, C)


def _bmm_f32(a, b):
    """a @ b batched over experts, accumulated and returned in float32
    (cuBLAS writes the float32 sums of bf16 operands; on the CPU the
    operands are widened first, as the reference does there)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda" and not (torch.is_grad_enabled() and (
            a.requires_grad or b.requires_grad)):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def moe_apply(p, x, cfg: ModelConfig):
    """x [B,S,D] -> [B,S,D]."""
    B, S, D = x.shape
    r = route(p, x, cfg)
    G, M, k = r.topi.shape
    E, C, dt, dev = cfg.n_experts, r.C, x.dtype, x.device
    n = E * G * C                      # slots, expert-major, then group
    g = torch.arange(G, device=dev)[:, None, None]
    slot = torch.where(r.keep, (r.topi * G + g) * C + r.pos, n)
    tok = (g * M + torch.arange(M, device=dev)[None, :, None]).expand(
        G, M, k)
    # each slot's token (G*M, a zero row, when empty) and combine weight;
    # the dropped choices all land in the spare entry n
    src = torch.full((n + 1,), G * M, dtype=torch.long, device=dev)
    src.scatter_(0, slot.reshape(-1), tok.reshape(-1))
    w = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    w.scatter_(0, slot.reshape(-1), r.topv.to(dt).float().reshape(-1))
    src, w = src[:n], w[:n]
    rows = torch.cat([x.reshape(G * M, D), x.new_zeros(1, D)])
    xin = rows[src].view(E, G * C, D)
    h = F.silu(_bmm_f32(xin, p.wg)).to(dt) * _bmm_f32(xin, p.wi).to(dt)
    out = _bmm_f32(h, p.wo).to(dt).view(n, D)
    y = torch.zeros(G * M + 1, D, dtype=torch.float32, device=dev)
    y.index_add_(0, src, out.float() * w[:, None])
    return y[:G * M].to(dt).view(B, S, D)


def aux_loss(p, x, cfg: ModelConfig):
    """The Switch load-balancing loss E * sum_e f_e * P_e of x [B,S,D]:
    f_e the share of tokens whose top gate is expert e (ties to the
    lower expert, as ``argmax``), P_e the mean gate; float32."""
    gates = torch.softmax(torch.matmul(x.float(), p.router), dim=-1)
    top1 = torch.argmax(gates, dim=-1)
    f = torch.mean(F.one_hot(top1, cfg.n_experts).float(), dim=(0, 1))
    P = torch.mean(gates, dim=(0, 1))
    return cfg.n_experts * torch.sum(f * P)
