"""End-to-end training on the PyTorch/CUDA port: a ~100M-parameter LM
for a few hundred steps, the port's counterpart of
examples/train_100m.py (the same model and CLI, plus ``--device``).

Uses the port's whole training stack: the data pipeline, AdamW with the
cosine schedule, the model's loss with each layer rematerialised, the
fault-tolerant trainer with async step-atomic checkpoints -- on the card
unless ``--device cpu`` is given.  A rerun with the same ``--ckpt-dir``
resumes from its last checkpoint.

    PYTHONPATH=src python examples/train_100m_torch.py --steps 300 \
        [--batch 8] [--seq 256] [--ckpt-dir DIR] [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models.model import build
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainConfig, init_state, \
    make_train_step
from repro_torch.train.trainer import LoopConfig, Trainer


def main(argv=None):
    """Trains, prints the losses, and returns (loss history, trainer,
    the step it resumed from)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_100m"),
        help="checkpoint directory (default: under $TMPDIR)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    # ~100M params: granite-3-2b geometry scaled down
    cfg = dataclasses.replace(
        get_config("granite-3-2b"),
        name="granite-100m", n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32_000)
    print(f"model: {cfg.name}  params ≈ {cfg.n_params()/1e6:.0f}M")

    model = build(cfg, device=args.device)
    params = model.init(torch.Generator(model.device).manual_seed(0))
    state = init_state(params)

    tcfg = TrainConfig(opt=adamw.AdamWConfig(
        lr=6e-4, warmup_steps=20, total_steps=args.steps))
    step_fn = make_train_step(model, tcfg)

    data = Pipeline(DataConfig(vocab_size=cfg.vocab_size, batch=args.batch,
                               seq_len=args.seq, seed=0))

    def batch_fn(step):
        return {"tokens": torch.from_numpy(data.batch_at(step)).to(
            model.device)}

    trainer = Trainer(step_fn, batch_fn,
                      LoopConfig(total_steps=args.steps, ckpt_every=50,
                                 ckpt_dir=args.ckpt_dir, log_every=10))
    state, start = trainer.resume_or_init(state)
    if start:
        print(f"resumed from checkpoint at step {start}")
    state, hist = trainer.run(state, start)
    if hist:
        print(f"done. loss {hist[0]:.3f} -> {hist[-1]:.3f} over "
              f"{len(hist)} steps; stragglers={trainer.n_stragglers} "
              f"restarts={trainer.n_restarts}")
    return hist, trainer, start


if __name__ == "__main__":
    main()
