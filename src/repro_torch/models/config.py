"""Architecture configuration (port of `repro.models.config`), dense
family."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """The reference's fields that the dense family reads; the other
    families' fields come with them (ROADMAP Queue A 8)."""

    name: str
    family: str  # 'dense' is the one family ported
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

    act: str = "swiglu"  # the ported MLP is swiglu
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16

    max_seq: int = 4096

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    def padded_vocab(self, multiple: int = 16) -> int:
        """Vocab padded for TP divisibility (Megatron practice); logits at pad
        ids are masked so the math is unchanged."""
        return ((self.vocab + multiple - 1) // multiple) * multiple

    def param_count(self) -> int:
        """Approximate total parameters (embedding + blocks), for 6ND: the
        reference's formula for the dense family (norms count one vector
        of d each, biases none)."""
        d, f, hd = self.d_model, self.d_ff, self.head_dim
        qh, kh = self.num_heads, self.num_kv_heads
        attn = d * qh * hd + 2 * d * kh * hd + qh * hd * d
        ffn = (3 if self.act == "swiglu" else 2) * d * f
        total = self.num_layers * (attn + ffn + 2 * d) + self.vocab * d
        if not self.tie_embeddings:
            total += self.vocab * d
        return int(total)
