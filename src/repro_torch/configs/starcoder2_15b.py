"""starcoder2-15b — GQA, RoPE [arXiv:2402.19173] (the reference's config).

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152. LayerNorm + GELU
(tanh form) + biases, sliding window 4096 per the model card.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    sliding_window=4096,
    rope_theta=100_000.0,
)
