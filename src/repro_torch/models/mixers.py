"""Sequence mixers: softmax attention (port of `repro.models.mixers`,
attention only; M-RoPE, RWKV6 and Hymba come with their families, ROADMAP
Queue A 8)."""
from __future__ import annotations

import math

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_rope, chunked_attention, linear


def _normal(gen, shape, cfg: ArchConfig, fan_in: int, device):
    return torch.randn(shape, generator=gen, dtype=cfg.dtype,
                       device=device) * (1.0 / math.sqrt(fan_in))


def init_attention(gen, cfg: ArchConfig, device, lead: tuple[int, ...] = ()):
    """wq, wk, wv, wo (and the biases with `qkv_bias`), each with the
    leading dims `lead` (the stacked layer axis)."""
    d, hd, qh, kh = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    p = {"wq": _normal(gen, lead + (d, qh * hd), cfg, d, device),
         "wk": _normal(gen, lead + (d, kh * hd), cfg, d, device),
         "wv": _normal(gen, lead + (d, kh * hd), cfg, d, device),
         "wo": _normal(gen, lead + (qh * hd, d), cfg, qh * hd, device)}
    if cfg.qkv_bias:
        for name, width in (("bq", qh * hd), ("bk", kh * hd), ("bv", kh * hd)):
            p[name] = torch.zeros(lead + (width,), dtype=cfg.dtype,
                                  device=device)
    return p


def _qkv(p, x, cfg: ArchConfig):
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = linear(x, p["wq"], p.get("bq")).reshape(b, s, cfg.num_heads, hd)
    k = linear(x, p["wk"], p.get("bk")).reshape(b, s, cfg.num_kv_heads, hd)
    v = linear(x, p["wv"], p.get("bv")).reshape(b, s, cfg.num_kv_heads, hd)
    return q, k, v


def _rotate(q, k, cfg: ArchConfig, positions):
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


def attention_train(p, x, cfg: ArchConfig, *, positions, causal: bool = True):
    q, k, v = _qkv(p, x, cfg)
    q, k = _rotate(q, k, cfg, positions)
    out = chunked_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    b, s = x.shape[:2]
    return linear(out.reshape(b, s, -1), p["wo"])
