"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1:2 [arXiv:2402.19427]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,       # MQA
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    lru_width=2560,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="recurrentgemma-2b-smoke", n_layers=5, d_model=64,
    n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512,
    local_window=16, lru_width=64)
