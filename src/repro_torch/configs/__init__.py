"""Architecture registry: the reference's ten configurations and their
reduced variants (port of `repro.configs`).

    cfg = get_config("qwen2-moe-a2.7b")
    small = reduced(cfg)            # 2 layers, d_model 128, 4 experts
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ArchConfig

_MODULES = {
    "stablelm-1.6b": "stablelm_1_6b",
    "deepseek-67b": "deepseek_67b",
    "rwkv6-7b": "rwkv6_7b",
    "hymba-1.5b": "hymba_1_5b",
    "starcoder2-15b": "starcoder2_15b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "whisper-medium": "whisper_medium",
    "dbrx-132b": "dbrx_132b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    try:
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; options: "
                         f"{sorted(_MODULES)}") from None
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


def reduced(cfg: ArchConfig, *, seq: int = 64) -> ArchConfig:
    """The reference's same-family reduced variant for CPU tests: 2 layers,
    4 heads of 32, d_ff 256, vocab 503 (padded to 512); 4 experts top-2
    (a shared expert of 128), SSM state 8, a window of seq // 2, a 2-layer
    encoder over 24 frames, 16 patches, M-RoPE sections (4, 6, 6)."""
    heads, head_dim = 4, 32
    kv = max(1, round(heads * cfg.num_kv_heads / cfg.num_heads))
    changes = dict(num_layers=2, d_model=heads * head_dim, num_heads=heads,
                   num_kv_heads=kv, head_dim=head_dim, d_ff=256, vocab=503,
                   max_seq=max(seq * 2, 128))
    if cfg.num_experts:
        changes.update(num_experts=4, experts_per_token=2)
        if cfg.shared_expert_ff:
            changes.update(shared_expert_ff=128)
    if cfg.ssm_state:
        changes.update(ssm_state=8, ssm_heads=heads)
    if cfg.sliding_window:
        changes.update(sliding_window=min(cfg.sliding_window, seq // 2))
    if cfg.encoder_layers:
        changes.update(encoder_layers=2, encoder_seq=24)
    if cfg.vision_patches:
        changes.update(vision_patches=16)
    if cfg.mrope_sections is not None:
        changes.update(mrope_sections=(4, 6, 6))  # head_dim/2 = 16 channels
    return dataclasses.replace(cfg, **changes)


__all__ = ["ARCH_NAMES", "ArchConfig", "all_configs", "get_config", "reduced"]
