"""Blockwise QSGD quantize -> dequantize (port of `repro.kernels.qsgd`).

Each 1024-element tile is scaled by its own max-abs, with stochastic
rounding from uniforms given as an input (drawn outside the kernel, so the
kernel is deterministic and both sides of a comparison see the same draws).
The CUDA kernel is `csrc/qsgd.cu` (a block a tile, every load before the
tile's max-abs); a CPU tensor takes the plain version
`ref.qsgd_quantize_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, census
from repro_torch.kernels.ref import qsgd_quantize_ref

TILE = 1024  # the span of one scale: part of the operator, not a tiling
_DTYPES = (torch.float32, torch.bfloat16)
_LANE = 4  # values of x a thread of the kernel takes in one load


def _qsgd_lane_values(x: torch.Tensor, u: torch.Tensor,
                      out: torch.Tensor) -> int:
    """Values of x a thread of the kernel moves in one load or store: 4
    (16 bytes of f32, 8 of bf16, beside 16 bytes of u) where x and out start
    on the grid of 4 of their values and u on the 16-byte grid; else 1, the
    scalar-lane variant, for views at an element offset. Every tile starts
    1024 values on, so the base pointers decide; a fresh out always lies on
    the grid."""
    lane = _LANE * x.element_size()
    if (x.data_ptr() % lane == 0 and out.data_ptr() % lane == 0
            and u.data_ptr() % 16 == 0):
        return _LANE
    return 1


def qsgd_quantize(x: torch.Tensor, u: torch.Tensor, *,
                  levels: int = 8) -> torch.Tensor:
    """x: (N,) f32/bf16 and u: (N,) f32 uniforms, N % TILE == 0 (the
    backend pads). Returns the dequantized (N,) tensor in x's dtype."""
    if x.dim() != 1 or x.dtype not in _DTYPES:
        raise ValueError(f"qsgd_quantize takes x (N,) f32/bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if u.shape != x.shape or u.dtype != torch.float32:
        raise ValueError(f"qsgd_quantize takes u {tuple(x.shape)} f32, got "
                         f"{tuple(u.shape)} {u.dtype}")
    if x.shape[0] % TILE:
        raise ValueError(f"qsgd_quantize needs N % {TILE} == 0, got {x.shape[0]}")
    if levels < 1:
        raise ValueError(f"qsgd_quantize needs levels >= 1, got {levels}")
    if u.device != x.device:
        raise ValueError("qsgd_quantize: x and u on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qsgd_quantize runs on cuda or cpu, not {x.device}")
    if census.card(x, u) and not (x.is_contiguous() and u.is_contiguous()):
        raise ValueError("qsgd_quantize takes contiguous tensors")
    if census.faked(x, u):
        return census.launch("qsgd_quantize", (x, u),
                             lambda: torch.empty_like(x))
    if x.device.type == "cpu":
        return census.plain("qsgd_quantize", (x, u),
                            lambda: qsgd_quantize_ref(x, u, levels=levels,
                                                      tile=TILE))
    out = torch.empty_like(x)
    n_tiles = x.shape[0] // TILE
    if n_tiles == 0:
        return out
    lib = _build.library()
    _build.check(lib.qsgd_launch(
        x.data_ptr(), u.data_ptr(), out.data_ptr(), n_tiles, float(levels),
        int(x.dtype == torch.bfloat16), _qsgd_lane_values(x, u, out),
        _build.stream_of(x)), "qsgd_quantize")
    _build.LAUNCHES["qsgd_quantize"] += 1
    return out
