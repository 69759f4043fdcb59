"""Plain PyTorch versions of the port's kernels (port of `repro.kernels.ref`).

Each function computes what its CUDA kernel computes, in the same float
operation order, on the same padded/tiled views, so a kernel and its plain
version agree bit for bit. The wrappers use these for CPU tensors; the tests
hold them against the JAX reference and `chip_smoke.py` holds the kernels
against them on the card. They repeat the kernels' arithmetic and are no
yardstick of speed.

Two habits of PyTorch that would break the bitwise match are avoided here:

- `a / python_float` on a CUDA tensor multiplies by the reciprocal, so a
  divisor that must be exact is a tensor on the same device;
- `torch.add(h, q, alpha=a)` may fuse into one multiply-add, so `h + a * q`
  is written as two operations, as the kernels do.
"""
from __future__ import annotations

import numpy as np
import torch


def randk_scale(d: int, k: int) -> float:
    """The Rand-k scale d/k rounded to f32, as JAX rounds the Python float."""
    return float(np.float32(d / k))


def qsgd_quantize_ref(x: torch.Tensor, u: torch.Tensor, *, levels: int,
                      tile: int = 1024) -> torch.Tensor:
    """Blockwise stochastic quantization (the TPU-native QSGD variant).

    x: (N,) f32/bf16 with N % tile == 0; u: (N,) f32 uniforms in [0, 1).
    Each `tile` block is scaled by its own max-abs; unbiased conditional on
    the block scale.
    """
    xt = x.reshape(-1, tile).to(torch.float32)
    ut = u.reshape(-1, tile)
    scale = torch.amax(torch.abs(xt), dim=1, keepdim=True) + 1e-30
    s = torch.tensor(float(levels), dtype=torch.float32, device=x.device)
    y = torch.abs(xt) / scale * s
    f = torch.floor(y)
    q = f + (ut < (y - f)).to(torch.float32)
    out = torch.sign(xt) * q * (scale / s)
    return out.reshape(x.shape).to(x.dtype)


def randk_mask_ref(x: torch.Tensor, starts: torch.Tensor, *, d: int,
                   k: int) -> torch.Tensor:
    """Dense circular-window Rand-k, batched over clients.

    x: (M, Dp) possibly padded past the real flat length d; starts: (M,).
    Q(x)[m, i] = x[m, i] * f32(d/k) for (i - starts[m]) mod d < k, i < d,
    else 0.
    """
    dp = x.shape[1]
    idx = torch.arange(dp, dtype=torch.int64, device=x.device)
    off = torch.remainder(idx[None, :] - starts[:, None].to(torch.int64), d)
    inside = (off < k) & (idx[None, :] < d)
    scaled = x.to(torch.float32) * randk_scale(d, k)
    return torch.where(inside, scaled, torch.zeros_like(scaled)).to(x.dtype)


def diana_shift_update_ref(h, q_own, mh, q_mean, alpha: float,
                           beta: float | None = None):
    """Fused DIANA state update (Algorithm 3/5 lines 7-11):
        direction = H_t + Q_mean
        h'        = h  + alpha * Q_own
        H'        = H_t + beta  * Q_mean
    `beta` defaults to alpha. Returns (direction, h', H'). All f32 math,
    cast back to the input dtypes.
    """
    f = torch.float32
    if beta is None:
        beta = alpha
    direction = mh.to(f) + q_mean.to(f)
    h_new = h.to(f) + alpha * q_own.to(f)
    mh_new = mh.to(f) + beta * q_mean.to(f)
    return (direction.to(q_mean.dtype), h_new.to(h.dtype),
            mh_new.to(mh.dtype))
