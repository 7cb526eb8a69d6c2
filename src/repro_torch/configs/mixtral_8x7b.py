"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32_000,
    window=4096,        # sliding-window attention
    n_experts=8,
    top_k=2,
)

SMOKE = dataclasses.replace(
    CONFIG, name="mixtral-8x7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, window=32, n_experts=4, top_k=2)
