"""Compression operators (port of `repro.compression.ops`).

Every unbiased operator Q satisfies E[Q(x)] = x and
E||Q(x) - x||^2 <= omega * ||x||^2 for a known omega (paper Assumption 1);
TopK is biased and kept only as the error-feedback contrast baseline.

`compress(gen, x)` returns the dense reconstruction Q(x) (the algorithms'
math needs the decompressed vector), drawing its randomness from the
`torch.Generator` `gen`; `bits(size)` accounts for what would travel on the
wire. The batched simulator path (`backend.compress_clients`) runs Rand-k
and QSGD through the kernels instead of these per-vector forms.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.api import tree_flatten
from repro_torch.kernels.ref import randk_scale


@runtime_checkable
class Compressor(Protocol):
    def compress(self, gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        """Return the dense reconstruction Q(x)."""
        ...

    def omega(self, size: int) -> float:
        """Variance bound omega for a vector of `size` elements."""
        ...

    def bits(self, size: int) -> int:
        """Bits on the wire for a vector of `size` float32 elements."""
        ...


def _k_of(k: int | None, fraction: float | None, size: int) -> int:
    if k is not None:
        return max(1, min(k, size))
    return max(1, min(size, int(fraction * size)))


def _idx_bits(size: int) -> int:
    return max(1, int(np.ceil(np.log2(max(size, 2)))))


@dataclasses.dataclass(frozen=True)
class Identity:
    """No compression: Q(x) = x, omega = 0."""

    def compress(self, gen, x):
        return x

    def omega(self, size):
        return 0.0

    def bits(self, size):
        return 32 * size


@dataclasses.dataclass(frozen=True)
class RandK:
    """Rand-k sparsification with the circular-window sampler.

    Q(x) = (d/k) * sum_{i in S} x_i e_i with S a circular window of k
    coordinates starting at a uniform offset. Every coordinate has marginal
    inclusion probability exactly k/d, so Q is unbiased with
    omega = d/k - 1 exact. `fraction` sets k = max(1, floor(fraction * d))
    when `k` is None.
    """

    k: int | None = None
    fraction: float | None = 0.02

    def __post_init__(self):
        if self.k is None and self.fraction is None:
            raise ValueError(
                "RandK needs either k or fraction; both are None. "
                "Pass k=<int> or fraction=<float in (0, 1]>.")

    def _k(self, size: int) -> int:
        return _k_of(self.k, self.fraction, size)

    def compress(self, gen, x):
        flat = x.reshape(-1)
        d = flat.shape[0]
        k = self._k(d)
        start = torch.randint(0, d, (), generator=gen, device=x.device)
        off = torch.remainder(torch.arange(d, device=x.device) - start, d)
        kept = torch.where(off < k, flat * randk_scale(d, k),
                           torch.zeros_like(flat))
        return kept.reshape(x.shape).to(x.dtype)

    def omega(self, size):
        return size / self._k(size) - 1.0

    def bits(self, size):
        # 32-bit value + ceil(log2(d))-bit index per coordinate
        return self._k(size) * (32 + _idx_bits(size))


@dataclasses.dataclass(frozen=True)
class TopK:
    """Top-k by magnitude. BIASED (kept as a contrast baseline only)."""

    k: int | None = None
    fraction: float | None = 0.02

    def __post_init__(self):
        if self.k is None and self.fraction is None:
            raise ValueError(
                "TopK needs either k or fraction; both are None. "
                "Pass k=<int> or fraction=<float in (0, 1]>.")

    def _k(self, size: int) -> int:
        return _k_of(self.k, self.fraction, size)

    def compress(self, gen, x):
        flat = x.reshape(-1)
        k = self._k(flat.shape[0])
        idx = torch.topk(torch.abs(flat), k).indices
        out = torch.zeros_like(flat).index_copy_(0, idx, flat[idx])
        return out.reshape(x.shape)

    def omega(self, size):
        # not an unbiased operator: no omega at any dimension
        return float("nan")

    def bits(self, size):
        return self._k(size) * (32 + _idx_bits(size))


@dataclasses.dataclass(frozen=True)
class QSGDQuantizer:
    """QSGD stochastic quantization (Alistarh et al., 2017).

    Q(x) = ||x||_2 * sign(x) * u / s with u ~ stochastic rounding of
    s*|x|/||x||_2 to the integer grid {0..s}. Unbiased;
    omega <= min(d/s^2, sqrt(d)/s). The batched simulator path uses the
    blockwise kernel instead (one max-abs scale per 1024-element tile).
    """

    levels: int = 8  # s

    def compress(self, gen, x):
        flat = x.reshape(-1).to(torch.float32)
        norm = torch.linalg.vector_norm(flat)
        s = float(self.levels)
        scaled = torch.where(norm > 0, torch.abs(flat) / norm * s,
                             torch.zeros_like(flat))
        floor = torch.floor(scaled)
        u = floor + (torch.rand(flat.shape, generator=gen, device=x.device)
                     < scaled - floor)
        out = norm * torch.sign(flat) * u / s
        return out.reshape(x.shape).to(x.dtype)

    def omega(self, size):
        s = float(self.levels)
        return min(size / s**2, np.sqrt(size) / s)

    def bits(self, size):
        # norm (32) + sign+level per coordinate
        lvl_bits = max(1, int(np.ceil(np.log2(self.levels + 1)))) + 1
        return 32 + size * lvl_bits


@dataclasses.dataclass(frozen=True)
class NaturalCompression:
    """Natural compression (Horvath et al., 2019): stochastic rounding to
    powers of two. Unbiased with omega = 1/8; ~9 bits/coordinate."""

    def compress(self, gen, x):
        flat = x.reshape(-1).to(torch.float32)
        absx = torch.abs(flat)
        # decompose |x| = 2^e * m, m in [1, 2)
        safe = torch.where(absx > 0, absx, torch.ones_like(absx))
        lo = torch.exp2(torch.floor(torch.log2(safe)))
        # round to 2^e w.p. (2^{e+1}-|x|)/2^e else 2^{e+1} -> unbiased
        p_up = (absx - lo) / lo
        up = torch.rand(flat.shape, generator=gen, device=x.device) < p_up
        out = torch.where(absx > 0,
                          torch.sign(flat) * lo * torch.where(up, 2.0, 1.0),
                          torch.zeros_like(flat))
        return out.reshape(x.shape).to(x.dtype)

    def omega(self, size):
        return 1.0 / 8.0

    def bits(self, size):
        return 9 * size


def tree_ravel(tree):
    """Concatenate all leaves (JAX's leaf order) into one flat f32 vector.

    Returns (flat, unravel) where unravel(flat) rebuilds the pytree with the
    leaves' own shapes and dtypes.
    """
    leaves, unflatten = tree_flatten(tree)
    sizes = [leaf.numel() for leaf in leaves]
    offsets = np.cumsum([0] + sizes)
    flat = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])

    def unravel(vec):
        return unflatten([
            vec[offsets[i]:offsets[i + 1]].reshape(leaf.shape).to(leaf.dtype)
            for i, leaf in enumerate(leaves)
        ])

    return flat, unravel


def tree_compression_bits(compressor, tree) -> int:
    """Total wire bits for one compressed message of this pytree."""
    return sum(compressor.bits(leaf.numel()) for leaf in tree_flatten(tree)[0])


def tree_omega(compressor, tree) -> float:
    """Worst-case (max over leaves) omega for per-leaf compression."""
    return max(compressor.omega(leaf.numel()) for leaf in tree_flatten(tree)[0])


_REGISTRY = {
    "identity": Identity,
    "none": Identity,
    "randk": RandK,
    "topk": TopK,
    "qsgd": QSGDQuantizer,
    "natural": NaturalCompression,
}


def get_compressor(name: str, **kwargs) -> Compressor:
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown compressor {name!r}; options: {sorted(_REGISTRY)}") from None
    return cls(**kwargs)
