"""Fault-tolerant training loop; the port of ``repro.train.trainer``.

  * step-atomic async checkpoints every ``ckpt_every`` steps (a crash at
    any point resumes from the last committed step; the data pipeline
    replays deterministically from that step),
  * failure handling -- any exception in the step (preemption, device
    loss, injected fault) triggers restore-from-latest + replay; bounded
    retries,
  * straggler mitigation -- a step exceeding ``straggler_factor x`` the
    rolling median latency is logged and counted (on a multi-host
    deployment this signal feeds the coordinator's replace-node
    decision; here it drives tests).

A step's time ends when its loss is read back (the device has finished
it); ``CheckpointManager.restore(like, device=...)`` is the port's
elastic restart onto another device.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Callable, Optional

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.train.train_step import TrainState


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_n: int = 3
    max_retries: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


class Trainer:
    def __init__(self, step_fn: Callable, batch_fn: Callable,
                 cfg: LoopConfig, fault_hook: Optional[Callable] = None):
        """step_fn(state, batch)->(state, metrics); batch_fn(step)->batch;
        fault_hook(step) may raise to inject failures (tests)."""
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.fault_hook = fault_hook
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep_n=cfg.keep_n)
        self.step_times: list[float] = []
        self.n_stragglers = 0
        self.n_restarts = 0

    def resume_or_init(self, init_state: TrainState):
        state, step = self.ckpt.restore(init_state)
        if state is None:
            return init_state, 0
        return state, step

    def run(self, state: TrainState, start_step: int = 0):
        cfg = self.cfg
        step = start_step
        retries = 0
        history = []
        while step < cfg.total_steps:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                t0 = time.time()
                batch = self.batch_fn(step)
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])   # waits for the device
                dt = time.time() - t0
                self.step_times.append(dt)
                if len(self.step_times) >= 5:
                    med = statistics.median(self.step_times[-20:])
                    if dt > cfg.straggler_factor * med:
                        self.n_stragglers += 1
                history.append(loss)
                if step % cfg.log_every == 0:
                    print(f"[train] step {step:5d} loss {loss:.4f} "
                          f"({dt*1e3:.0f} ms)", flush=True)
                step += 1
                retries = 0
                if step % cfg.ckpt_every == 0:
                    self.ckpt.save(step, state)
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 -- fault boundary
                retries += 1
                self.n_restarts += 1
                print(f"[train] FAULT at step {step}: {e!r} -- "
                      f"restoring (retry {retries}/{cfg.max_retries})",
                      flush=True)
                if retries > cfg.max_retries:
                    raise
                self.ckpt.wait()
                restored, rstep = self.ckpt.restore(state)
                if restored is not None:
                    state, step = restored, rstep
                # else: replay from the initial state
        self.ckpt.wait()
        self.ckpt.save(step, state, block=True)
        return state, history
