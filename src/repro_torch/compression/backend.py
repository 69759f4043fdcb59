"""Compression backend: one dispatch layer for every compression, wire
primitive and fused shift update (port of `repro.compression.backend`).

Two backends implement the same primitives:

``cuda``
    The kernels in `repro_torch.kernels`: a CUDA tensor launches the
    hand-written kernel, a CPU tensor takes the kernel's plain version (the
    wrapper decides by the tensor's device, nothing else). One launch covers
    the whole flat buffer: the simulator ravels the client gradients once
    and compresses all M clients in a single call.
``reference``
    Always the plain PyTorch versions (`repro_torch.kernels.ref`), on any
    device. It is the semantics oracle: `chip_smoke.py` runs it on the card
    beside ``cuda`` and asks for the same trajectory.

Selection: the `backend=` argument of the caller (`get_backend(name)`),
and nothing else; None means "cuda". No environment variable switches a
run onto the plain versions.

Consumers: the simulator (`core.algorithms`, `core.rules`) through
`compress_clients` / `tree_diana_shift` / `diana_shift_flat`; the production
wire (`core.dist`) through `wire_exchange` (which reaches `wire_compress`,
`pack_slab`, `unpack_slab` and `unpack_reduce`) and `wire_decompress`.

Randomness: a round's draws (the Rand-k window starts, the QSGD uniforms)
come from the caller's `torch.Generator`, or are handed in through `draws`
so a test can feed the JAX reference's exact draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.compression.ops import Identity, QSGDQuantizer, RandK, tree_ravel
from repro_torch.core.api import tree_flatten
from repro_torch.kernels import ref
from repro_torch.kernels.diana_shift import diana_shift_update
from repro_torch.kernels.pack import pack_slab, unpack_reduce, unpack_slab
from repro_torch.kernels.qsgd import TILE, qsgd_quantize
from repro_torch.kernels.randk import (
    BLOCK_ROWS,
    randk_compress,
    randk_decompress,
    randk_mask,
)

__all__ = ["BACKENDS", "BLOCK_ROWS", "CompressionBackend", "TILE",
           "WIRE_DTYPES", "bf16_level_mean", "get_backend", "level_mean"]

BACKENDS = ("reference", "cuda")

# Wire transport formats of the shared wire's slab (core.dist validates the
# method/wire combinations): 'f32' (quantized or not), 'bf16', and the byte
# lattices 'packed8' / 'packed4' reduced by the fused unpack_reduce kernel.
WIRE_DTYPES = ("f32", "bf16", "packed8", "packed4")


def _identity(x):
    return x


def _rank_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks of `dim` accumulated in order: r = 0 assigned, then each
    later rank added."""
    acc = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def level_mean(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The wire's collective mean over a level's rank dimension `dim` (the
    reference's `lax.pmean`): the ranks accumulated in order (r = 0, 1, ...),
    then divided by R, for every level and method. The reference's
    `unpack_reduce_ref` fixes this schedule; on power-of-two rank counts it
    equals XLA's pmean bit for bit. The divisor is a tensor: PyTorch divides
    a CUDA tensor by a Python float as a multiply by the reciprocal."""
    acc = _rank_sum(x, dim)
    return acc / torch.tensor(float(x.shape[dim]), dtype=acc.dtype,
                              device=acc.device)


def bf16_level_mean(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The reference's `lax.pmean` of bf16 values, as XLA computes it: the
    ranks' bf16 values summed in f32 in rank order, the sum rounded to bf16
    (the psum's result), then divided by R at bf16. Returns bf16."""
    acc = _rank_sum(x.to(torch.bfloat16).to(torch.float32), dim)
    return acc.to(torch.bfloat16) / torch.tensor(
        float(x.shape[dim]), dtype=torch.bfloat16, device=acc.device)


def tree_ravel_clients(tree):
    """Ravel a client-stacked pytree (leaves (M, *s)) into one (M, D) f32
    buffer. Returns (mat, unravel); unravel(mat) restores per-leaf shapes
    and dtypes."""
    leaves, unflatten = tree_flatten(tree)
    m = leaves[0].shape[0]
    sizes = [leaf[0].numel() for leaf in leaves]
    offsets = np.cumsum([0] + sizes)
    mat = torch.cat([leaf.reshape(m, -1).to(torch.float32) for leaf in leaves],
                    dim=1)

    def unravel(out):
        return unflatten([
            out[:, offsets[i]:offsets[i + 1]].reshape(leaf.shape).to(leaf.dtype)
            for i, leaf in enumerate(leaves)
        ])

    return mat, unravel


def _pad_cols(mat: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-mat.shape[1]) % multiple
    if pad:
        mat = F.pad(mat, (0, pad))
    return mat


@dataclasses.dataclass(frozen=True)
class CompressionBackend:
    """Static dispatch between the plain versions and the CUDA kernels."""

    name: str = "cuda"

    def __post_init__(self):
        if self.name not in BACKENDS:
            raise ValueError(f"unknown backend {self.name!r}; options: {BACKENDS}")

    @property
    def is_cuda(self) -> bool:
        return self.name == "cuda"

    # -- flat batched primitives ----------------------------------------------

    def randk_dense(self, mat, starts, *, d: int, k: int):
        """Dense Q(x) for M clients: circular window mask + (d/k) scale.

        mat: (M, Dp) with d <= Dp the real flat length (columns past d come
        out 0); the simulator passes the unpadded (M, d) matrix.
        """
        if self.is_cuda:
            return randk_mask(mat, starts, d=d, k=k)
        return ref.randk_mask_ref(mat, starts, d=d, k=k)

    def qsgd_dense(self, mat, u, *, levels: int):
        """Blockwise-QSGD quantize->dequantize; mat (M, Dp), Dp % TILE == 0."""
        m, dp = mat.shape
        flat, uf = mat.reshape(m * dp), u.reshape(m * dp)
        if self.is_cuda:
            out = qsgd_quantize(flat, uf, levels=levels)
        else:
            out = ref.qsgd_quantize_ref(flat, uf, levels=levels, tile=TILE)
        return out.reshape(m, dp)

    def diana_shift_flat(self, h, q_own, mh, q_mean, *, alpha: float,
                         beta: float | None = None):
        """Fused DIANA update -> (direction, h', H'): on flat (N,) buffers,
        or on a group's ranks h, Q_own (G, C, n) beside its mean H, Q_mean
        (G, n) (the rank-stacked wire)."""
        if self.is_cuda:
            return diana_shift_update(h, q_own, mh, q_mean, alpha=alpha,
                                      beta=beta)
        return ref.diana_shift_update_ref(h, q_own, mh, q_mean, alpha, beta)

    # -- pytree entry points (the simulator hot path) -------------------------

    def compress_clients(self, comp, gen, tree, draws=None):
        """Q(g_m) for all M clients of a client-stacked pytree in ONE launch.

        Ravel once -> compress once -> unravel. `draws` optionally replaces
        the generator's draws for this call: the window starts, shape (M,),
        for Rand-k, or the uniforms, shape (M, Dp), for QSGD.
        """
        if isinstance(comp, Identity):
            return tree
        mat, unravel = tree_ravel_clients(tree)
        m, d = mat.shape
        if isinstance(comp, RandK):
            k = comp._k(d)
            starts = draws if draws is not None else torch.randint(
                0, d, (m,), generator=gen, device=mat.device)
            starts = torch.as_tensor(starts, device=mat.device).to(torch.int32)
            return unravel(self.randk_dense(mat, starts, d=d, k=k))
        if isinstance(comp, QSGDQuantizer):
            # one scale per 1024-element tile: the operator needs the padding
            padded = _pad_cols(mat, TILE)
            u = draws if draws is not None else torch.rand(
                padded.shape, generator=gen, device=mat.device)
            u = torch.as_tensor(u, dtype=torch.float32, device=mat.device)
            dense = self.qsgd_dense(padded, u, levels=comp.levels)
            return unravel(dense[:, :d])
        # generic operators (TopK, NaturalCompression, user-defined): one
        # ravel, the operator itself runs once per client
        dense = torch.stack([comp.compress(gen, mat[i]) for i in range(m)])
        return unravel(dense)

    def tree_diana_shift(self, h_tree, qo_tree, mh_tree, qm_tree, *,
                         alpha: float, beta: float | None = None):
        """Fused DIANA update over whole pytrees (same structure/shapes).

        Returns (direction_tree, h_tree', mh_tree'). On the cuda backend this
        is ONE kernel launch over the raveled buffers; the reference backend
        stays per-leaf and is the semantics oracle.
        """
        if self.is_cuda:
            h, unravel = tree_ravel(h_tree)
            qo, _ = tree_ravel(qo_tree)
            mh, _ = tree_ravel(mh_tree)
            qm, _ = tree_ravel(qm_tree)
            outs = self.diana_shift_flat(h, qo, mh, qm, alpha=alpha, beta=beta)
            return tuple(unravel(o) for o in outs)
        h_leaves, unflatten = tree_flatten(h_tree)
        trips = [
            ref.diana_shift_update_ref(a, b, c, d, alpha, beta)
            for a, b, c, d in zip(h_leaves, tree_flatten(qo_tree)[0],
                                  tree_flatten(mh_tree)[0],
                                  tree_flatten(qm_tree)[0])
        ]
        return tuple(unflatten([t[i] for t in trips]) for i in range(3))


    # -- wire primitives (the shared-seed Rand-block collective) -------------

    def wire_exchange(self, rows, start_block, *, k_blocks: int,
                      block_rows: int, groups: int, weight=None,
                      wire_dtype: str = "f32", levels: int | None = None,
                      quant_u=None, gather=None):
        """One level of the shared wire for a stack of ranks: the circular
        gather of every rank's k-row slab, then the level's collective mean.

        rows: (R, N, D), the R = G * C ranks of G groups (pods) that each
        exchange among their C ranks; every rank uses the one window that
        starts at `start_block` (a device scalar). Returns (own (R, K, D),
        mean (G, K, D)), both f32.

        `gather` is the level's all_gather (`launch.distributed`): it
        takes the message of this process's ranks and returns the G groups'
        C ranks each, in rank order; None (one process holding every rank)
        is the identity. Then `rows` may hold a process's share of one
        group (G = 1). Only the message crosses it: the packed bytes and
        their weighted scales, or the (weighted) slab at its transport's
        width; `own` stays local.

        `weight` (R,) f32, or None: each rank's participation weight, which
        scales its contribution to the mean only (the elastic hook; `own`
        stays unweighted so the shift updates see the rank's own message).

        Transport (`wire_dtype`), as the reference's `wire_exchange`:

        'f32'      the slab as is; with `levels` set it is first quantized
                   through the pack -> unpack pair (shared uniforms
                   `quant_u`, (K, D)), so every value is what the packed
                   transports move. Weighted as ((b - L) * s) * w.
        'bf16'     own is the slab's bf16 round trip; the weighted own
                   values are averaged at bf16 (`bf16_level_mean`).
        'packed8'  pack_slab (levels <= 127), own = unpack_slab with the
                   UNWEIGHTED scales, mean = unpack_reduce of each group's
                   gathered bytes with the scales times the weights, so
                   the weight folds as (b - L) * (s * w). `gather`
                   moves the bytes and the weighted scales.
        'packed4'  the same, two rows per byte (levels <= 7).
        """
        if gather is None:
            gather = _identity
        vals = self.wire_compress(rows, start_block, k_blocks=k_blocks,
                                  block_rows=block_rows)
        r, k, d = vals.shape
        w = None if weight is None else weight.reshape(r, 1, 1)
        if wire_dtype in ("packed8", "packed4"):
            nib = wire_dtype == "packed4"
            packed, scales = self.pack_slab(vals, quant_u, levels=levels,
                                            nibble=nib)
            del vals
            own = self.unpack_slab(packed, scales, levels=levels, n_rows=k,
                                   nibble=nib)
            wscales = gather(scales if w is None else scales * w)
            packed = gather(packed)
            mean = self.unpack_reduce(
                packed.reshape(groups, -1, *packed.shape[1:]),
                wscales.reshape(groups, -1, *scales.shape[1:]),
                levels=levels, n_rows=k, nibble=nib)
            return own, mean
        if levels is not None:
            packed, scales = self.pack_slab(vals, quant_u, levels=levels)
            vals = self.unpack_slab(packed, scales, levels=levels, n_rows=k)
        if wire_dtype == "bf16":
            vals = vals.to(torch.bfloat16).to(torch.float32)
        shared = vals if w is None else vals * w
        if wire_dtype == "bf16":
            # the lane is bf16: the mean reads only the bf16 of each value
            shared = gather(shared.to(torch.bfloat16))
            return vals, bf16_level_mean(shared.reshape(groups, -1, k, d),
                                         dim=1).to(torch.float32)
        shared = gather(shared)
        return vals, level_mean(shared.reshape(groups, -1, k, d), dim=1)

    def wire_compress(self, rows, start_block, *, k_blocks: int,
                      block_rows: int):
        """(..., N, D) rows -> (..., k_blocks*block_rows, D) circular gather
        + scale."""
        if self.is_cuda:
            return randk_compress(rows, start_block, k_blocks=k_blocks,
                                  block_rows=block_rows)
        return ref.randk_compress_ref(rows, start_block, k_blocks=k_blocks,
                                      block_rows=block_rows)

    def wire_decompress(self, vals, start_block, *, n_rows: int,
                        block_rows: int):
        """(..., K, D) vals -> (..., n_rows, D) zero-padded circular scatter."""
        if self.is_cuda:
            return randk_decompress(vals, start_block, n_rows=n_rows,
                                    block_rows=block_rows)
        return ref.randk_decompress_ref(vals, start_block, n_rows=n_rows,
                                        block_rows=block_rows)

    def pack_slab(self, vals, u, *, levels: int, nibble: bool = False):
        """Quantize + bit-pack slabs -> (packed uint8, f32 scales)."""
        if self.is_cuda:
            return pack_slab(vals, u, levels=levels, nibble=nibble)
        return ref.pack_slab_ref(vals, u, levels=levels, nibble=nibble)

    def unpack_slab(self, packed, scales, *, levels: int, n_rows: int,
                    nibble: bool = False):
        """Decode packed slabs back to (..., n_rows, D) f32 values."""
        if self.is_cuda:
            return unpack_slab(packed, scales, levels=levels, n_rows=n_rows,
                               nibble=nibble)
        return ref.unpack_slab_ref(packed, scales, levels=levels,
                                   n_rows=n_rows, nibble=nibble)

    def unpack_reduce(self, packed, scales, *, levels: int, n_rows: int,
                      nibble: bool = False):
        """Gathered (G, C, Kp[/2], D) packed slabs + (G, C, Kp, 1) scales
        -> each group's (G, n_rows, D) f32 mean, in rank order."""
        if self.is_cuda:
            return unpack_reduce(packed, scales, levels=levels, n_rows=n_rows,
                                 nibble=nibble)
        return ref.unpack_reduce_ref(packed, scales, levels=levels,
                                     n_rows=n_rows, nibble=nibble)


def get_backend(name: str | CompressionBackend | None = None) -> CompressionBackend:
    """Resolve a backend: the explicit argument, else "cuda"."""
    if isinstance(name, CompressionBackend):
        return name
    return CompressionBackend(name="cuda" if name is None else name)
