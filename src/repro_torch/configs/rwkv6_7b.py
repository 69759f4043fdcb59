"""rwkv6-7b — Finch, data-dependent decay [arXiv:2404.05892] (the
reference's config).

32L d_model=4096 (attention-free) d_ff=14336 vocab=65536. 64 heads of size
64. The channel mix uses relu^2.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,
    num_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    head_dim=64,
    attention_mixer="rwkv6",
    norm="layernorm",
    act="relu2",
    rope_theta=0.0,  # attention-free; no rotary stream
)
