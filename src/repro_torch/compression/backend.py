"""Compression backend: one dispatch layer for every per-client compression
and fused shift update of the simulator (port of the simulator half of
`repro.compression.backend`).

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

Selection: pass a name, or set REPRO_TORCH_COMPRESSION_BACKEND (default
"cuda").

Randomness: a round's draws (the Rand-k window starts, the QSGD uniforms)
come from the caller's `torch.Generator`, or are handed in through `draws`
so a test can feed the JAX reference's exact draws.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.compression.ops import Identity, QSGDQuantizer, RandK, tree_ravel
from repro_torch.core.api import tree_flatten
from repro_torch.kernels import ref
from repro_torch.kernels.diana_shift import diana_shift_update
from repro_torch.kernels.qsgd import TILE, qsgd_quantize
from repro_torch.kernels.randk import randk_mask

__all__ = ["BACKENDS", "CompressionBackend", "TILE", "get_backend"]

BACKENDS = ("reference", "cuda")
_ENV_VAR = "REPRO_TORCH_COMPRESSION_BACKEND"


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
        """Fused DIANA update on flat (N,) buffers -> (direction, h', H')."""
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


def get_backend(name: str | CompressionBackend | None = None) -> CompressionBackend:
    """Resolve a backend: explicit arg > $REPRO_TORCH_COMPRESSION_BACKEND > cuda."""
    if isinstance(name, CompressionBackend):
        return name
    if name is None:
        name = os.environ.get(_ENV_VAR, "cuda")
    return CompressionBackend(name=name)
