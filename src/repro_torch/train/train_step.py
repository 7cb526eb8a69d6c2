"""Training step: loss -> grads -> (optionally compressed) update; the
port of ``repro.train.train_step``.

With ``accum_steps > 1`` the batch splits into that many micro-batches
along axis 0; their gradients are summed in float32 and divided by the
count, as the reference's inner scan does (peak activation memory
follows the micro-batch).  With one, the gradients keep the parameters'
dtype, as ``jax.grad`` gives them.  ``compress_fn`` maps the gradient
dict before the update (the reference's hook for compressed cross-pod
gradients).

The state is never written in place: a step builds new parameters and
moments, so a step that raises leaves the state it was given as it was.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.models import layers as L
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: object        # the model's parameters (an nn.Module)
    opt: adamw.OptState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    accum_steps: int = 1


def init_state(params) -> TrainState:
    """The state of a first step: ``params`` made trainable
    (``layers.trainable``, in place) and zero moments."""
    return TrainState(params=L.trainable(params), opt=adamw.init(params))


def make_train_step(model, tcfg: TrainConfig, compress_fn=None):
    """Returns train_step(state, batch) -> (state, metrics): metrics
    ``loss``, ``grad_norm`` and ``lr``, float32 tensors on the model's
    device (reading one waits for the step)."""

    def grads_of(params, batch):
        named = dict(params.named_parameters())
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss.detach(), dict(zip(named, grads))

    def train_step(state: TrainState, batch):
        if tcfg.accum_steps > 1:
            a = tcfg.accum_steps

            def micro(x, i):
                return x.reshape((a, x.shape[0] // a) + x.shape[1:])[i]

            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in state.params.named_parameters()}
            for i in range(a):
                lv, g = grads_of(state.params,
                                 {k: micro(v, i) for k, v in batch.items()})
                loss = loss + lv
                grads = {n: grads[n] + g[n] for n in grads}
            loss = loss / a
            grads = {n: g / a for n, g in grads.items()}
        else:
            loss, grads = grads_of(state.params, batch)

        if compress_fn is not None:
            grads = compress_fn(grads)

        params, opt, om = adamw.update(tcfg.opt, grads, state.opt,
                                       state.params)
        metrics = {"loss": loss, **om}
        return TrainState(params=params, opt=opt), metrics

    return train_step
