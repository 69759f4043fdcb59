"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]
(the reference's config).

24L d_model=2048 16H (kv=16) per-expert d_ff=1408 vocab=151936, MoE 60
experts top-4. The 4 shared experts are folded into one always-on dense FFN
of width 4*1408 = 5632 (the same function).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    qkv_bias=True,
    num_experts=60,
    experts_per_token=4,
    shared_expert_ff=5632,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1_000_000.0,
)
