"""deepseek-67b — llama-arch [arXiv:2401.02954] (the reference's config).

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400. RMSNorm + SwiGLU +
RoPE; the deepest configuration.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10_000.0,
)
