"""Dense circular-window Rand-k for M clients (port of `repro.kernels.randk`'s
simulator half, `randk_mask`).

The algorithms consume the dense reconstruction Q(x), and for a circular
window Rand-k that is a masked scale: one element-wise pass over the (M, Dp)
matrix of raveled client gradients, each client with its own window start.
The CUDA kernel is `csrc/randk_mask.cu`; a CPU tensor takes the plain
version `ref.randk_mask_ref`. The wire half (`randk_compress` /
`randk_decompress`) belongs to the next slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import randk_mask_ref, randk_scale

_DTYPES = (torch.float32, torch.bfloat16)


def randk_mask(x: torch.Tensor, starts: torch.Tensor, *, d: int,
               k: int) -> torch.Tensor:
    """Q(x)[m, i] = x[m, i] * f32(d/k) if (i - starts[m]) mod d < k and
    i < d, else 0.

    x: (M, Dp) f32 or bf16, contiguous; starts: (M,) int32 on x's device;
    `d` is the real flat length (d <= Dp): columns past it are padding and
    come out 0.
    """
    if x.dim() != 2 or x.dtype not in _DTYPES:
        raise ValueError(f"randk_mask takes x (M, Dp) f32/bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    m, dp = x.shape
    if starts.shape != (m,) or starts.dtype != torch.int32:
        raise ValueError(f"randk_mask takes starts ({m},) int32, got "
                         f"{tuple(starts.shape)} {starts.dtype}")
    if not 0 < k <= d <= dp:
        raise ValueError(f"randk_mask needs 0 < k <= d <= Dp, got k={k}, "
                         f"d={d}, Dp={dp}")
    if starts.device != x.device:
        raise ValueError("randk_mask: x and starts on different devices")
    if x.device.type == "cpu":
        return randk_mask_ref(x, starts, d=d, k=k)
    if x.device.type != "cuda":
        raise ValueError(f"randk_mask runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and starts.is_contiguous()):
        raise ValueError("randk_mask takes contiguous tensors")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.library()
    _build.check(lib.randk_mask_launch(
        x.data_ptr(), starts.data_ptr(), out.data_ptr(), m, dp, d, k,
        randk_scale(d, k), int(x.dtype == torch.bfloat16),
        _build.stream_of(x)), "randk_mask")
    _build.LAUNCHES["randk_mask"] += 1
    return out
