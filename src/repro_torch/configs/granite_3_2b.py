"""granite-3-2b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49_155,  # padded to 49408 for the 16-way model axis
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="granite-3-2b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=515)
