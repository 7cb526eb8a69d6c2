"""AdamW + global-norm clipping + cosine schedule; the port of
``repro.optim.adamw``.

Moments are float32 whatever the parameter's dtype (bf16 parameters,
float32 optimizer state).  The arithmetic is the reference's, operation
for operation: the schedule and the bias corrections ``b ** step`` in
float32 tensors, each update added in float32 and cast back to the
parameter's dtype.

Trees are name -> tensor: a model's ``named_parameters`` (the port's
modules, layers in a ``ModuleList``) or a dict of the same names.  The
decoupled decay follows the reference's rule, ``ndim >= 2``, on the rank
of the leaf in the JAX layout, where each stack of layers (``STACKS``)
is one leaf with the layer on axis 0: a layer's norm scale ([d] here,
[L, d] there) and mamba2's ``A_log``, ``Dskip`` and ``dt_bias`` decay,
``ln_f.scale`` does not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.models.model import jax_path, named_tensors, with_tensors


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor   # int32 scalar, on the parameters' device
    mu: dict             # name -> float32 tensor
    nu: dict             # name -> float32 tensor


def init(params) -> OptState:
    ps = named_tensors(params)
    dev = next(iter(ps.values())).device
    mu = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          for n, p in ps.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=mu, nu={n: m.clone() for n, m in mu.items()})


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int or an int tensor): linear
    warm-up, then a cosine down to ``min_lr_frac`` of ``lr``; float32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree):
    """sqrt of the sum of every leaf's float32 squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in named_tensors(tree).values()))


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether the weight decay applies to the leaf ``name``: the
    reference's ``p.ndim >= 2`` on its JAX rank (one more for a layer of
    a stack)."""
    return p.dim() + (jax_path(name)[1] is not None) >= 2


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: OptState, params):
    """Returns (new_params, new_state, metrics); ``params`` and ``state``
    are left as they are (new tensors throughout), so a step that fails
    changes nothing."""
    ps, gs = named_tensors(params), named_tensors(grads)
    gnorm = global_norm({n: gs[n] for n in ps})
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    new, mu, nu = {}, {}, {}
    for n, p in ps.items():
        g = gs[n].float() * scale
        m2 = cfg.b1 * state.mu[n] + (1 - cfg.b1) * g
        v2 = cfg.b2 * state.nu[n] + (1 - cfg.b2) * g * g
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        if decays(n, p):   # decoupled decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        new[n] = (p.float() - lr * delta).to(p.dtype)
        mu[n], nu[n] = m2, v2
    return with_tensors(params, new), OptState(step=step, mu=mu, nu=nu), {
        "grad_norm": gnorm, "lr": lr}
