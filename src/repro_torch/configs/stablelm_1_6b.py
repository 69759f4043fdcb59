"""stablelm-1.6b — [hf:stabilityai/stablelm-2-1_6b] (the reference's config).

24L d_model=2048 32H (GQA kv=32, i.e. MHA) d_ff=5632 vocab=100352.
StableLM-2 uses LayerNorm + SwiGLU + (partial) RoPE; full-dim RoPE here, as
in the reference.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    norm="layernorm",
    act="swiglu",
    rope_theta=10_000.0,
)
