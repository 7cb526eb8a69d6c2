"""mamba2-2.7b [ssm] — SSD state-space duality [arXiv:2405.21060]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,          # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,  # padded to 50432
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,     # 80 heads (d_inner 5120 / 64)
    ssm_groups=1,
    ssm_chunk=128,
)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-2.7b-smoke", n_layers=2, d_model=64,
    vocab_size=512, ssm_state=16, ssm_headdim=16, ssm_chunk=8)
