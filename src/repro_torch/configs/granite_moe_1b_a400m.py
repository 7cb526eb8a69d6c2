"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,  # padded to 49408
    n_experts=32,
    top_k=8,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="granite-moe-1b-a400m-smoke", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=32, vocab_size=515, n_experts=8, top_k=2)
