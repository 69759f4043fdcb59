"""Architecture registry (port of `repro.configs`).

stablelm-1.6b is the one configuration ported; the other nine of the
reference raise until their families are (ROADMAP Queue A 8).

    cfg = get_config("stablelm-1.6b")
    small = reduced(cfg)            # 2 layers, d_model 128, vocab 503
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ArchConfig

_MODULES = {"stablelm-1.6b": "stablelm_1_6b"}
_NOT_PORTED = ("deepseek-67b", "rwkv6-7b", "hymba-1.5b", "starcoder2-15b",
               "qwen2-vl-2b", "qwen2.5-32b", "qwen2-moe-a2.7b",
               "whisper-medium", "dbrx-132b")

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported yet: the port runs the dense family "
            "(stablelm-1.6b); the other families follow (ROADMAP Queue A 8)")
    try:
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; options: "
                         f"{sorted(_MODULES) + sorted(_NOT_PORTED)}") from None
    return mod.CONFIG


def reduced(cfg: ArchConfig, *, seq: int = 64) -> ArchConfig:
    """The reference's reduced variant for CPU tests, dense family: 2
    layers, 4 heads of 32, d_ff 256, vocab 503 (padded to 512)."""
    heads, head_dim = 4, 32
    kv = max(1, round(heads * cfg.num_kv_heads / cfg.num_heads))
    return dataclasses.replace(
        cfg, num_layers=2, d_model=heads * head_dim, num_heads=heads,
        num_kv_heads=kv, head_dim=head_dim, d_ff=256, vocab=503,
        max_seq=max(seq * 2, 128))


__all__ = ["ARCH_NAMES", "ArchConfig", "get_config", "reduced"]
