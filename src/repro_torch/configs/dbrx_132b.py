"""dbrx-132b — 16 experts top-4, fine-grained MoE [hf:databricks/dbrx-base]
(the reference's config).

40L d_model=6144 48H (GQA kv=8) per-expert d_ff=10752 vocab=100352,
MoE 16 experts top-4. LayerNorm + GLU + RoPE (~132B total, ~36B active).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    num_experts=16,
    experts_per_token=4,
    norm="layernorm",
    act="swiglu",
    rope_theta=500_000.0,
)
