"""The LM train step on the compressed wire (port of `repro.launch.steps`'s
train half).

One step is one communication round of the paper's Algorithms 2-3 at the
pod's scale: every client rank of the mesh computes its gradient of the
language-model loss on its own slice of the batch, the ranks exchange their
compressed gradients on the production wire (`core.dist`, shared
Rand-block slabs through the four wire kernels), and the server applies the
aggregated direction with its optimizer. The reference spreads the ranks
over TPU devices; here one card runs them all, stacked on a leading rank
dimension, so the mesh is a `launch.mesh.VirtualMesh` of names and sizes.

Layers of a step: per-client gradients (a loop over the M clients, autograd
on the transformer), the wire, the optimizer.

Not ported yet (each raises): NASTYA (`local_steps > 1`), the elastic
per-client weights, `debug_metrics`, cohort shift swapping and the
prefill/serve steps (ROADMAP Queue A 9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.api import tree_flatten, tree_leaves, tree_map
from repro_torch.core.dist import CompressedAggregation, DianaState
from repro_torch.launch.mesh import (
    VirtualMesh,
    client_axes,
    data_axes,
    num_clients,
    num_pods,
    pod_axes,
)
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig
from repro_torch.optim import optimizers as optim

_NOT_PORTED = "is not ported yet (ROADMAP Queue A 9)"


class TrainState(NamedTuple):
    """The reference's train state, rank-stacked: `shifts` (M, [n_slots,]
    *param), `mean_shift` (P, [n_slots,] *param) on pod meshes else
    ([n_slots,] *param), `pod_shifts` (P, [n_slots,] *param),
    `pod_mean_shift` ([n_slots,] *param); None where the method keeps no
    such table."""

    params: Any
    shifts: Any
    mean_shift: Any
    step: torch.Tensor
    opt_state: Any = ()
    pod_shifts: Any = None
    pod_mean_shift: Any = None


def configure_agg(agg: CompressedAggregation, mesh: VirtualMesh,
                  local_steps: int = 1) -> CompressedAggregation:
    """Bind an aggregation config to the mesh's wire topology: the two-level
    wire on a pod mesh (inner level over the in-pod "data" ranks, outer over
    "pod"), else the single-level wire over every client."""
    if local_steps > 1:
        raise NotImplementedError(f"NASTYA (local_steps > 1) {_NOT_PORTED}")
    if pod_axes(mesh):
        return dataclasses.replace(agg, client_axes=data_axes(mesh),
                                   pod_axes=pod_axes(mesh),
                                   pod_size=num_pods(mesh))
    return dataclasses.replace(agg, client_axes=client_axes(mesh),
                               pod_axes=(), pod_size=1)


def _make_optimizer(optimizer: str, lr: float) -> optim.Optimizer:
    if optimizer == "sgd":
        return optim.sgd(lr)
    if optimizer == "momentum":
        return optim.momentum(lr)
    if optimizer == "adamw":
        return optim.adamw(lr, weight_decay=0.1)
    raise ValueError(optimizer)


def init_train_state(seed, cfg: ArchConfig, agg: CompressedAggregation,
                     m: int, *, optimizer: str = "sgd", lr: float = 3e-3,
                     mesh: VirtualMesh | None = None, local_steps: int = 1,
                     device=None) -> TrainState:
    """Initial state: random parameters from `seed` (an int or a
    torch.Generator), zero shift tables shaped for the mesh's wire (pass
    `mesh`; without it `agg` is used as it is), the optimizer's state."""
    if mesh is not None:
        agg = configure_agg(agg, mesh, local_steps)
    params = transformer.init_params(seed, cfg, device)
    tables = agg.init(params, m) or DianaState(None, None)
    opt_state = _make_optimizer(optimizer, lr).init(params)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return TrainState(params, tables.shifts, tables.mean_shift, step,
                      opt_state, tables.pod_shifts, tables.pod_mean_shift)


def make_train_step(cfg: ArchConfig, mesh: VirtualMesh, *,
                    agg: CompressedAggregation, lr: float = 3e-3,
                    eta: float | None = None, local_steps: int = 1,
                    remat="full", ce: str = "gather", optimizer: str = "sgd",
                    elastic: bool = False, debug_metrics: bool = False):
    """Returns step(state, batch, gen, slots=None, *, draws=None) ->
    (state, metrics).

    batch: {"tokens": (M * b, S + 1) integer tensor}, client-major (rows
    [c*b, (c+1)*b) are client c's). gen: a torch.Generator on the state's
    device, from which the wire draws its windows (unused for the leaves
    that `draws` covers, see `core.dist`). slots: the round's shared batch
    index as a (1,) vector (`data.pipeline.shared_slots_for_step`), needed
    by per-slot methods ('diana_rr'). metrics: {"loss", "grad_norm"}.

    The step updates the state's per-slot shift tables in place (the
    reference's step donates its state); take a copy first to keep one.
    The backend of the wire's kernels is `agg.backend`.
    """
    if eta is not None and local_steps == 1:
        raise ValueError("eta is the NASTYA server stepsize and requires "
                         "local_steps > 1 (with one local step the server "
                         "stepsize IS lr; Algorithms 2-3)")
    if elastic:
        raise NotImplementedError(f"elastic=True {_NOT_PORTED}")
    if debug_metrics:
        raise NotImplementedError(f"debug_metrics=True {_NOT_PORTED}")
    m = num_clients(mesh)
    agg = configure_agg(agg, mesh, local_steps)
    opt = _make_optimizer(optimizer, lr)
    stateful = agg.rule.has_shifts
    slotted = agg.rule.slotted

    def client_grads(params, batch_c):
        """Per-client (loss, grad): the M clients one after another, each
        gradient written into its row of the (M, *param) stack."""
        leaves, unflatten = tree_flatten(params)
        grads = [torch.empty((m,) + tuple(p.shape), dtype=p.dtype,
                             device=p.device) for p in leaves]
        losses = []
        for c in range(m):
            req = [p.detach().requires_grad_(True) for p in leaves]
            loss = transformer.loss_fn(
                unflatten(req), tree_map(lambda x: x[c], batch_c), cfg,
                remat=remat, ce=ce)
            for buf, g in zip(grads, torch.autograd.grad(loss, req)):
                buf[c] = g
            losses.append(loss.detach())
        return torch.stack(losses), unflatten(grads)

    def check_batch(batch):
        leads = {x.shape[0] for x in tree_leaves(batch)}
        if len(leads) != 1:
            raise ValueError(f"batch leaves disagree on leading rows "
                             f"{sorted(leads)}")
        rows = leads.pop()
        if rows == 0 or rows % m:
            raise ValueError(
                f"batch has {rows} leading rows, not divisible by m = {m} — "
                "the step consumes client-major (m * b)-row batches")

    def step(state: TrainState, batch, gen, slots=None, *, draws=None):
        check_batch(batch)
        if slots is None:
            if slotted:
                raise ValueError(
                    f"method {agg.method!r} keeps per-slot shift tables: "
                    "pass the round's shared slot (slots, a (1,) vector; "
                    "see data.pipeline.shared_slots_for_step)")
            slots = np.zeros((local_steps,), np.int32)
        slots = np.asarray(slots)
        if slots.shape != (local_steps,):
            raise ValueError(f"slots must be a ({local_steps},) vector of "
                             f"shared batch indices, got {slots.shape}")
        bsz = tree_leaves(batch)[0].shape[0] // m
        batch_c = tree_map(lambda x: x.reshape((m, bsz) + tuple(x.shape[1:])),
                           batch)
        losses, g = client_grads(state.params, batch_c)
        sq = None
        for x in tree_leaves(g):
            s = torch.sum(torch.square(x.to(torch.float32)))
            sq = s if sq is None else sq + s
        gnorm = torch.sqrt(sq / m)
        dstate = DianaState(state.shifts, state.mean_shift, state.pod_shifts,
                            state.pod_mean_shift) if stateful else None
        direction, nd = agg.aggregate(g, dstate, gen, slot=int(slots[0]),
                                      draws=draws)
        del g  # the per-client stack is the step's largest transient
        nd = nd or DianaState(None, None)
        updates, new_opt = opt.update(
            tree_map(lambda d: d.to(torch.float32), direction),
            state.opt_state, state.params)
        new_params = optim.apply_updates(state.params, updates)
        metrics = {"loss": torch.mean(losses), "grad_norm": gnorm}
        return TrainState(new_params, nd.shifts, nd.mean_shift,
                          state.step + 1, new_opt, nd.pod_shifts,
                          nd.pod_mean_shift), metrics

    return step
