"""qwen2-vl-2b — M-RoPE, dynamic resolution [arXiv:2409.12191] (the
reference's config).

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. The vision encoder
and projector are a stub: the batch carries precomputed patch embeddings
(B, 256, d_model); the language decoder applies M-RoPE with (t, h, w)
sections (16, 24, 24) over head_dim/2 = 64 channels.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    vision_patches=256,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1_000_000.0,
)
