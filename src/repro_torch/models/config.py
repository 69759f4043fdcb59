"""Architecture configuration shared by every model family (port of
`repro.models.config`)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'vlm' | 'audio'
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None

    # attention
    rope_theta: float = 1e4
    qkv_bias: bool = False
    sliding_window: int | None = None
    mrope_sections: tuple[int, int, int] | None = None  # (t, h, w) — qwen2-vl
    attention_mixer: str = "attn"  # 'attn' | 'rwkv6' | 'hymba'

    # ffn
    act: str = "swiglu"  # 'swiglu' | 'gelu' | 'relu2'
    num_experts: int = 0
    experts_per_token: int = 0
    shared_expert_ff: int = 0  # qwen2-moe shared experts as one fused FFN

    # ssm / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0  # hymba: number of parallel mamba heads

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub frame count (1500 for whisper)

    # vlm stub
    vision_patches: int = 0  # patches consumed per sample at train time

    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16

    max_seq: int = 4096

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.attention_mixer == "rwkv6"

    def padded_vocab(self, multiple: int = 16) -> int:
        """Vocab padded for TP divisibility (Megatron practice); logits at pad
        ids are masked so the math is unchanged."""
        return ((self.vocab + multiple - 1) // multiple) * multiple

    def supports_long_context(self) -> bool:
        """A sub-quadratic decode path exists (a recurrent mixer or a
        sliding window)."""
        return (self.attention_mixer in ("rwkv6", "hymba")
                or self.sliding_window is not None)

    def _ffn_mats(self) -> int:
        return 3 if self.act == "swiglu" else 2

    def param_count(self) -> int:
        """Approximate total parameters (embedding + blocks), for 6ND: the
        reference's formula (norms count one vector of d each, biases and
        the small per-head vectors none)."""
        d, f, hd = self.d_model, self.d_ff, self.head_dim
        qh, kh = self.num_heads, self.num_kv_heads
        attn = d * qh * hd + 2 * d * kh * hd + qh * hd * d
        if self.attention_mixer == "rwkv6":
            attn = 6 * d * d  # r, k, v, g, w projections + output
        elif self.attention_mixer == "hymba":
            ssm_inner = self.ssm_heads * hd
            attn += (2 * d * ssm_inner + ssm_inner * d
                     + ssm_inner * (2 * self.ssm_state + 2))
        n = self._ffn_mats()
        if self.num_experts:
            ffn = self.num_experts * n * d * f + d * self.num_experts
            if self.shared_expert_ff:
                ffn += n * d * self.shared_expert_ff
        else:
            ffn = n * d * f
        total = self.num_layers * (attn + ffn + 2 * d) + self.vocab * d
        if not self.tie_embeddings:
            total += self.vocab * d
        if self.is_encdec:
            total += self.encoder_layers * (4 * d * d + n * d * f + 2 * d)
            total += self.num_layers * (4 * d * d)  # cross-attn in decoder
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if not self.num_experts:
            return self.param_count()
        per_expert = self._ffn_mats() * self.d_model * self.d_ff
        dense_ffn = self.num_experts * per_expert
        active_ffn = self.experts_per_token * per_expert
        return self.param_count() - self.num_layers * (dense_ffn - active_ffn)
