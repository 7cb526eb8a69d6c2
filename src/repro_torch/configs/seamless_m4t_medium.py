"""seamless-m4t-medium [audio] — enc-dec backbone [arXiv:2308.11596].

The speech frontend (fbank → conformer adaptor) is a STUB: input_specs
provides precomputed frame embeddings.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,         # decoder layers
    n_enc_layers=12,     # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,  # padded to 256256
    frontend="audio",
)

SMOKE = dataclasses.replace(
    CONFIG, name="seamless-m4t-medium-smoke", n_layers=2, n_enc_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512)
