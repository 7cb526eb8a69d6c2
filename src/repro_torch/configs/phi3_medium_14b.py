"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100_352,
)

SMOKE = dataclasses.replace(
    CONFIG, name="phi3-medium-14b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512)
