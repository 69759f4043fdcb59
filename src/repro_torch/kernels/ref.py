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
import torch.nn.functional as F

BLOCK_ROWS = 8  # the wire window's row-block: part of the operator (omega)


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
    cast back to the input dtypes: direction takes Q_mean's.

    The h-side (h, Q_own) and the H-side (H, Q_mean) only need matching
    shapes within each side: the wire passes a group's C ranks as h
    (G, C, n) beside the group's one mean H (G, n).
    """
    f = torch.float32
    if beta is None:
        beta = alpha
    direction = mh.to(f) + q_mean.to(f)
    h_new = h.to(f) + alpha * q_own.to(f)
    mh_new = mh.to(f) + beta * q_mean.to(f)
    return (direction.to(q_mean.dtype), h_new.to(h.dtype),
            mh_new.to(mh.dtype))


# ---------------------------------------------------------------------------
# the shared Rand-block wire (port of the reference's randk_compress_ref,
# randk_decompress_ref, pack_slab_ref, unpack_slab_ref and unpack_reduce_ref)
# ---------------------------------------------------------------------------

def _window(start_block: torch.Tensor, k_blocks: int, nb: int) -> torch.Tensor:
    """Block indices (start + i) mod nb, i < k_blocks, on start's device."""
    steps = torch.arange(k_blocks, dtype=torch.int64, device=start_block.device)
    return torch.remainder(start_block.to(torch.int64) + steps, nb)


def randk_compress_ref(rows: torch.Tensor, start_block: torch.Tensor, *,
                       k_blocks: int, block_rows: int = BLOCK_ROWS
                       ) -> torch.Tensor:
    """Circular block-aligned row gather + unbiased f32(nb/kb) scaling.

    rows: (..., N, D) with N % block_rows == 0 (a stack of ranks shares the
    one window); start_block: 0-dim integer tensor. Returns
    (..., k_blocks * block_rows, D) in rows' dtype, multiplied in f32.
    """
    *lead, n, d = rows.shape
    nb = n // block_rows
    blocks = rows.reshape(*lead, nb, block_rows, d)
    vals = blocks[..., _window(start_block, k_blocks, nb), :, :]
    vals = vals.reshape(*lead, k_blocks * block_rows, d)
    return (vals.to(torch.float32) * randk_scale(nb, k_blocks)).to(rows.dtype)


def randk_decompress_ref(vals: torch.Tensor, start_block: torch.Tensor, *,
                         n_rows: int, block_rows: int = BLOCK_ROWS
                         ) -> torch.Tensor:
    """Scatter (..., K, D) row blocks into an (..., n_rows, D) zero canvas
    at the circular window that starts at block `start_block`."""
    *lead, k, d = vals.shape
    kb, nb = k // block_rows, n_rows // block_rows
    canvas = torch.zeros(*lead, nb, block_rows, d, dtype=vals.dtype,
                         device=vals.device)
    canvas[..., _window(start_block, kb, nb), :, :] = vals.reshape(
        *lead, kb, block_rows, d)
    return canvas.reshape(*lead, n_rows, d)


def _pad_rows(x: torch.Tensor, block_rows: int) -> torch.Tensor:
    pad = (-x.shape[-2]) % block_rows
    return F.pad(x, (0, 0, 0, pad)) if pad else x


def pack_slab_ref(vals: torch.Tensor, u: torch.Tensor, *, levels: int,
                  nibble: bool = False, block_rows: int = BLOCK_ROWS):
    """Quantize + bit-pack wire slabs.

    vals: (..., K, D) f32/bf16; u: (K, D) f32 uniforms, shared by every
    slab of the stack. Rows pad to a `block_rows` multiple with zeros.
    Per-row max-abs scale, stochastic rounding to q in [-L, L], biased byte
    b = q + L (padding rows give b = L). nibble=True packs two consecutive
    ROWS per byte (lo | hi<<4). Returns (packed uint8 (..., Kp[/2], D),
    scales (..., Kp, 1) f32).
    """
    x = _pad_rows(vals.to(torch.float32), block_rows)
    ut = _pad_rows(u, block_rows)
    s = torch.tensor(float(levels), dtype=torch.float32, device=x.device)
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True) + 1e-30
    y = torch.abs(x) / amax * s
    f = torch.floor(y)
    q = torch.minimum(f + (ut < (y - f)).to(torch.float32), s)
    b = (torch.sign(x) * q + s).to(torch.int32)
    if nibble:
        *lead, kp, d = b.shape
        pairs = b.reshape(*lead, kp // 2, 2, d)
        b = pairs[..., 0, :] + 16 * pairs[..., 1, :]
    return b.to(torch.uint8), amax / s


def unpack_slab_ref(packed: torch.Tensor, scales: torch.Tensor, *,
                    levels: int, n_rows: int, nibble: bool = False
                    ) -> torch.Tensor:
    """Decode packed slabs: v = (b - L) * scale, trimmed to n_rows rows.
    The repository's only dequantization formula."""
    b = packed.to(torch.int32)
    if nibble:
        *lead, prows, d = b.shape
        b = torch.stack([b % 16, b // 16], dim=-2).reshape(*lead, 2 * prows, d)
    return ((b.to(torch.float32) - float(levels)) * scales)[..., :n_rows, :]


def unpack_reduce_ref(packed: torch.Tensor, scales: torch.Tensor, *,
                      levels: int, n_rows: int, nibble: bool = False
                      ) -> torch.Tensor:
    """The receive half of the packed collective: gathered slabs -> their
    mean, for each group of ranks.

    packed: ([G,] C, Kp[/2], D) uint8, the C ranks of each of G groups;
    scales: ([G,] C, Kp, 1) f32. Returns the ([G,] n_rows, D) f32 mean:
    each rank decoded as `unpack_slab_ref` decodes it, accumulated in rank
    order (rank 0 assigned, ranks 1..C-1 added in turn), divided by C (a
    tensor divisor: an exact division on every device).
    """
    c = packed.shape[-3]
    acc = unpack_slab_ref(packed.select(-3, 0), scales.select(-3, 0),
                          levels=levels, n_rows=n_rows, nibble=nibble)
    for r in range(1, c):
        acc = acc + unpack_slab_ref(packed.select(-3, r), scales.select(-3, r),
                                    levels=levels, n_rows=n_rows,
                                    nibble=nibble)
    return acc / torch.tensor(float(c), dtype=torch.float32,
                              device=acc.device)

