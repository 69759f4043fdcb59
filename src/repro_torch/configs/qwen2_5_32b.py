"""qwen2.5-32b — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B family] (the
reference's config).

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064. RMSNorm + SwiGLU +
RoPE + QKV bias.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab=152064,
    qkv_bias=True,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1_000_000.0,
)
