"""Circular-window Rand-k kernels (port of `repro.kernels.randk`).

Simulator half, `randk_mask`: the algorithms consume the dense
reconstruction Q(x), and for a circular window Rand-k that is a masked
scale: one element-wise pass over the (M, Dp) matrix of raveled client
gradients, each client with its own window start (`csrc/randk_mask.cu`).

Wire half, `randk_compress` / `randk_decompress`: the shared Rand-block
wire gathers a circular window of whole BLOCK_ROWS-row blocks from the row
view of a gradient leaf and scatters the exchanged slab back
(`csrc/randk_rows.cu`). Every rank of a wire level draws the same window,
so one launch covers the whole (R, N, D) stack of ranks, and the window's
start stays a tensor on the device: no host sync.

A CPU tensor takes the plain version in `ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, census
from repro_torch.kernels.ref import (
    BLOCK_ROWS,
    randk_compress_ref,
    randk_decompress_ref,
    randk_mask_ref,
    randk_scale,
)

_DTYPES = (torch.float32, torch.bfloat16)
# randk_mask rows up to one block of one-value lanes (kThreads *
# kLanesPerThread in csrc/randk_mask.cu) take the scalar variant
_MASK_SCALAR_ROW = 512


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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"randk_mask runs on cuda or cpu, not {x.device}")
    if census.card(x, starts):
        if not (x.is_contiguous() and starts.is_contiguous()):
            raise ValueError("randk_mask takes contiguous tensors")
        if dp >= 2**31:
            raise ValueError(f"randk_mask's kernel indexes a row in 32 bits: "
                             f"Dp < 2^31, got {dp}")
    # the kernel reads the k window values of each row
    read = m * k * x.element_size() + starts.numel() * 4
    if census.faked(x, starts):
        return census.launch("randk_mask", (x, starts),
                             lambda: torch.empty_like(x), read)
    if x.device.type == "cpu":
        return census.plain("randk_mask", (x, starts),
                            lambda: randk_mask_ref(x, starts, d=d, k=k), read)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.library()
    _build.check(lib.randk_mask_launch(
        x.data_ptr(), starts.data_ptr(), out.data_ptr(), m, dp, d, k,
        randk_scale(d, k), int(x.dtype == torch.bfloat16),
        _mask_lane_values(x, out), _build.stream_of(x)), "randk_mask")
    _build.LAUNCHES["randk_mask"] += 1
    return out


def _check_stack(name: str, x: torch.Tensor, start_block: torch.Tensor,
                 block_rows: int) -> None:
    if x.dim() not in (2, 3) or x.dtype not in _DTYPES:
        raise ValueError(f"{name} takes (N, D) or (R, N, D) f32/bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.shape[-2] % block_rows:
        raise ValueError(f"{name} needs rows % {block_rows} == 0, got "
                         f"{x.shape[-2]}")
    if start_block.dim() != 0 or start_block.dtype != torch.int32:
        raise ValueError(f"{name} takes start_block as a 0-dim int32 tensor, "
                         f"got {tuple(start_block.shape)} {start_block.dtype}")
    if start_block.device != x.device:
        raise ValueError(f"{name}: rows and start_block on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if census.card(x, start_block) and not x.is_contiguous():
        raise ValueError(f"{name} takes contiguous tensors")


def _block_lane_values(x: torch.Tensor, y: torch.Tensor,
                       block_rows: int) -> int:
    """Values in one lane of randk_compress's and randk_decompress's
    kernels, which move x into y a row block at a time: 16 bytes' worth (4
    f32 or 8 bf16) when x and y start on a 16-byte boundary and a block of
    block_rows rows spans a whole number of 16-byte lanes (always for 8
    rows: 8 * D * itemsize is a multiple of 16 for every D); else 1. The
    lanes are flat over the ranks' blocks, so the rank strides fall on the
    lanes' grid too."""
    span = block_rows * x.shape[-1] * x.element_size()
    if span % 16 == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0:
        return 16 // x.element_size()
    return 1


def _mask_lane_values(x: torch.Tensor, out: torch.Tensor) -> int:
    """Values in one lane of randk_mask's kernel: 16 bytes' worth (4 f32 or
    8 bf16) when every row of x and out starts on a 16-byte boundary and
    the row is longer than one block of one-value lanes covers; else 1 (the
    scalar variant: a short row is latency-bound, and more threads with one
    value each finish it sooner)."""
    dp = x.shape[-1]
    if (dp > _MASK_SCALAR_ROW and (dp * x.element_size()) % 16 == 0
            and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0):
        return 16 // x.element_size()
    return 1


def randk_compress(rows: torch.Tensor, start_block: torch.Tensor, *,
                   k_blocks: int, block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """out[..., i, :] = rows[..., ((s + i // 8) mod nb) * 8 + i % 8, :] *
    f32(nb / k_blocks), for the window of `k_blocks` blocks of `block_rows`
    rows that starts at block s = start_block.

    rows: (N, D) or (R, N, D) f32/bf16 with N % block_rows == 0 (a stack of
    R ranks shares the window); start_block: 0-dim int32 on rows' device.
    Returns (..., k_blocks * block_rows, D) in rows' dtype.
    """
    _check_stack("randk_compress", rows, start_block, block_rows)
    *lead, n, d = rows.shape
    nb = n // block_rows
    if not 0 < k_blocks <= nb:
        raise ValueError(f"randk_compress needs 0 < k_blocks <= N / "
                         f"{block_rows} = {nb}, got {k_blocks}")

    def empty():
        return torch.empty(*lead, k_blocks * block_rows, d, dtype=rows.dtype,
                           device=rows.device)

    def read(outs):  # the window's rows (as many bytes as it writes)
        return outs[0].numel() * outs[0].element_size() + 4

    if census.faked(rows, start_block):
        return census.launch("randk_compress", (rows, start_block), empty,
                             read)
    if rows.device.type == "cpu":
        return census.plain(
            "randk_compress", (rows, start_block),
            lambda: randk_compress_ref(rows, start_block, k_blocks=k_blocks,
                                       block_rows=block_rows), read)
    out = empty()
    if out.numel() == 0:
        return out
    lib = _build.library()
    _build.check(lib.randk_compress_launch(
        rows.data_ptr(), start_block.data_ptr(), out.data_ptr(),
        rows.numel() // (n * d), n, d, k_blocks, block_rows,
        randk_scale(nb, k_blocks), int(rows.dtype == torch.bfloat16),
        _block_lane_values(rows, out, block_rows), _build.stream_of(rows)),
        "randk_compress")
    _build.LAUNCHES["randk_compress"] += 1
    return out


def randk_decompress(vals: torch.Tensor, start_block: torch.Tensor, *,
                     n_rows: int, block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """Scatter (K, D) or (G, K, D) slabs into (..., n_rows, D) zero canvases
    at the circular window that starts at block `start_block`: the inverse
    of `randk_compress` up to its scale. Returns vals' dtype."""
    _check_stack("randk_decompress", vals, start_block, block_rows)
    *lead, k, d = vals.shape
    kb, nb = k // block_rows, n_rows // block_rows
    if n_rows % block_rows or not 0 < kb <= nb:
        raise ValueError(f"randk_decompress needs n_rows % {block_rows} == 0 "
                         f"and 0 < K / {block_rows} <= n_rows / {block_rows},"
                         f" got K={k}, n_rows={n_rows}")

    def empty():
        return torch.empty(*lead, n_rows, d, dtype=vals.dtype,
                           device=vals.device)

    if census.faked(vals, start_block):
        return census.launch("randk_decompress", (vals, start_block), empty)
    if vals.device.type == "cpu":
        return census.plain(
            "randk_decompress", (vals, start_block),
            lambda: randk_decompress_ref(vals, start_block, n_rows=n_rows,
                                         block_rows=block_rows))
    out = empty()
    if out.numel() == 0:
        return out
    lib = _build.library()
    _build.check(lib.randk_decompress_launch(
        vals.data_ptr(), start_block.data_ptr(), out.data_ptr(),
        vals.numel() // (k * d), n_rows, d, kb, block_rows,
        vals.element_size(), _block_lane_values(vals, out, block_rows),
        _build.stream_of(vals)), "randk_decompress")
    _build.LAUNCHES["randk_decompress"] += 1
    return out
