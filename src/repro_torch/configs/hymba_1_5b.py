"""hymba-1.5b — parallel attention + mamba heads [arXiv:2411.13676] (the
reference's config).

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16. Every
layer runs softmax-attention heads and Mamba-2/SSD heads in parallel and
mean-fuses the normalized head groups; sliding window 1024 on all layers
(the paper keeps 3 global layers) and no meta-tokens, as in the reference.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    attention_mixer="hymba",
    ssm_state=16,
    ssm_heads=25,
    sliding_window=1024,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10_000.0,
)
