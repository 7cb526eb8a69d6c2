"""Model/config system: every assigned architecture is a ModelConfig.

The port's own copy of ``repro.configs.base`` (stdlib only): the same
fields, properties and shape table, so a configuration means the same
model in both packages.

``family`` selects the backbone builder in ``repro_torch.models.model``
(the port builds every family):
  dense  — decoder-only transformer (GQA, RoPE, SwiGLU, opt. qk_norm/SWA)
  moe    — dense backbone with MoE FFN blocks (top-k routing)
  ssm    — mamba2 (SSD, attention-free)
  hybrid — recurrentgemma (RG-LRU + local attention, repeating pattern)
  encdec — encoder-decoder (seamless-m4t backbone; audio frontend stubbed)
  vlm    — decoder with M-RoPE + vision-patch embedding inputs (stubbed)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _pad256(v: int) -> int:
    return (v + 255) // 256 * 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // n_heads
    # attention options
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None    # sliding-window attention (mixtral)
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    ssm_conv: int = 4
    # hybrid (recurrentgemma)
    block_pattern: Tuple[str, ...] = ("attn",)  # repeating unit
    local_window: int = 2048
    lru_width: int = 0              # 0 → d_model
    # enc-dec
    n_enc_layers: int = 0
    # frontend stubs
    frontend: Optional[str] = None  # 'audio' | 'vision'
    n_patches: int = 256            # vlm: vision tokens per sequence
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (TP-friendly; e.g. granite's
        49155 does not divide the 16-way model axis)."""
        return _pad256(self.vocab_size)

    @property
    def d_inner(self) -> int:       # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:     # mamba2
        return self.d_inner // self.ssm_headdim

    def n_params(self) -> int:
        """Total parameter count (for 6ND roofline math)."""
        D, F, V, L = self.d_model, self.d_ff, self.padded_vocab, self.n_layers
        hd, H, K = self.hd, self.n_heads, self.n_kv_heads
        emb = V * D * (1 if self.tie_embeddings else 2)
        attn = D * H * hd + 2 * D * K * hd + H * hd * D
        mlp = 3 * D * F
        if self.family == "ssm":
            d_in = self.d_inner
            n = self.ssm_state
            per = (D * (2 * d_in + 2 * self.ssm_groups * n + self.ssm_heads)
                   + d_in * D + self.ssm_conv * (d_in + 2 * self.ssm_groups * n)
                   + 2 * self.ssm_heads)
            return emb + L * (per + 2 * D)
        if self.family == "moe":
            per = attn + self.n_experts * mlp + D * self.n_experts
            return emb + L * (per + 2 * D)
        if self.family == "hybrid":
            W = self.lru_width or D
            rec = D * 2 * W + W * D + 2 * (W * 4) + 3 * W  # gates+proj+conv+lru
            pat = self.block_pattern
            n_rec = sum(1 for b in (pat * ((L // len(pat)) + 1))[:L] if b == "rec")
            n_att = L - n_rec
            return emb + n_rec * (rec + mlp + 2 * D) + n_att * (attn + mlp + 2 * D)
        if self.family == "encdec":
            enc = self.n_enc_layers * (attn + mlp + 2 * D)
            dec = L * (2 * attn + mlp + 3 * D)  # self + cross
            return emb + enc + dec
        return emb + L * (attn + mlp + 2 * D)

    def n_active_params(self) -> int:
        """Activated params per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.n_params()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        dense_total = self.n_params()
        unused = L * (self.n_experts - self.top_k) * 3 * D * F
        return dense_total - unused


# ---------------------------------------------------------------- shapes

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic attention path);
# pure full-attention archs skip it per the assignment (see DESIGN.md).
SUBQUADRATIC = {"mamba2-2.7b", "recurrentgemma-2b", "mixtral-8x7b"}


def cell_status(arch: str, shape: str) -> str:
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return "skipped(full-attention)"
    return "run"
