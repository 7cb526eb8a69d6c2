"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

The vision tower is a STUB: input_specs provides precomputed patch
embeddings; the backbone applies M-RoPE over (t,h,w) position streams.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152_064,
    mrope_sections=(16, 24, 24),  # t/h/w split of the 64 rotary dims
    rope_theta=1_000_000.0,
    frontend="vision",
    n_patches=1024,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2-vl-7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, mrope_sections=(4, 6, 6),
    n_patches=8)
