"""qwen3-32b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,  # qwen3 uses explicit 128 (not d_model/n_heads)
    d_ff=25600,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-32b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512)
