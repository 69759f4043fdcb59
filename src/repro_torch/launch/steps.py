"""The LM train step on the compressed wire, and the prefill and serve
steps (port of `repro.launch.steps`).

One step is one communication round of the paper's Algorithms 2-3 at the
pod's scale: every client rank of the mesh computes its gradient of the
language-model loss on its own slice of the batch, the ranks exchange their
compressed gradients on the production wire (`core.dist`, shared
Rand-block slabs through the four wire kernels), and the server applies the
aggregated direction with its optimizer. The reference spreads the ranks
over TPU devices. Here one process runs them all, stacked on a leading
rank dimension, or W processes each run R_local = M / W of them, when the
agg's collective is a process group's (`launch.distributed`); the mesh is
a `launch.mesh.VirtualMesh` of names and sizes.

Layers of a step: per-client gradients (a loop over the process's
clients, autograd on the transformer), the wire, the optimizer.

The mesh's "model" axis (T shards of each client, `launch.sharding`) is
the reference's tensor parallelism. The wire compresses each split leaf
shard by shard (`core.dist`), and where the model axis spreads over
processes a process holds only its shards of every split leaf
(parameters, tables, optimizer state). The layers of every family
compute on the shards (`models.tp`, `sharding.model_shards`): the loss
and its gradient run on the process's shards of the parameters (on one
process, all T of them side by side), the processes of one client
exchange activations over their model group (and, for hymba's mixer,
its split projections and norms), never the whole weights, and the
gradient comes out as the process's shards; every reduction over the
shards adds them in shard order, so any spread of the mesh gives the
stacked run's bits. The norms add per-shard partial sums, so any layout
gives the stacked run's bits.

Spread over processes, a step gives every process the bits of the stacked
step: each process draws every rank's draws (the wire's, NASTYA's pod
permutations) and keeps its own; the loss is the mean of the gathered
per-rank losses, and the gradient norm and the debug metrics' table norms
sum per-rank partial sums, gathered, in rank order (on one process too).

With `local_steps > 1` the step is the paper's Q-NASTYA / DIANA-NASTYA
(Algorithms 4-5) at pod granularity: each pod runs `local_steps` local RR
steps at stepsize `lr` on the inner wire, the epoch gradient crosses the
outer wire once, and the server optimizer applies it at `eta`. On a flat
mesh every client is its own pod. `elastic` adds a per-client weights
vector (the wire's `weight`); `debug_metrics` adds compression diagnostics
to the metrics.

The prefill and serve steps take the reference's mesh too
(`make_prefill_step(cfg, mesh, cache_len=)`, `make_serve_step(cfg,
mesh)`): with T > 1 model shards each client's share of the requests runs
on the process's shards of the parameters, its cache laid out as the
reference's `cache_specs` lays it and computed on where it lies
(`models.mixers`' `*_decode_tp`); a mesh of one shard is the whole-layer
path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.compression.backend import _rank_sum
from repro_torch.core.api import tree_flatten, tree_leaves, tree_map
from repro_torch.core.dist import CompressedAggregation, DianaState
from repro_torch.kernels import census
from repro_torch.launch.mesh import (
    VirtualMesh,
    client_axes,
    data_axes,
    model_size,
    num_clients,
    num_pods,
    pod_axes,
)
from repro_torch.launch import distributed, sharding
from repro_torch.models import tp, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.optim import optimizers as optim


def host_orders(perm: torch.Tensor) -> np.ndarray:
    """The (P, L) pod orders `perm` (on the host) as an int64 array. Under
    the dry run's census (`kernels.census.active`), whose fake tensors
    hold no values, every pod's order is the identity: the draws and their
    copy to the host still run; only the values the host indexes the
    micro-batches by are not the draws'."""
    if census.active() is not None:
        return np.tile(np.arange(perm.shape[1], dtype=np.int64),
                       (perm.shape[0], 1))
    # analysis: allow[trace-hazard] NASTYA indexes each pod's micro-batches
    # on the host; blocks CUDA-graph capture (ROADMAP parked)
    return perm.numpy()


class TrainState(NamedTuple):
    """The reference's train state, rank-stacked: `shifts` (M, [n_slots,]
    *param), `mean_shift` (P, [n_slots,] *param) on pod meshes else
    ([n_slots,] *param), `pod_shifts` (P, [n_slots,] *param),
    `pod_mean_shift` ([n_slots,] *param); None where the method keeps no
    such table. Spread over processes, each holds its own rows of the
    per-rank and per-pod tables and, where the model axis spreads too,
    its own shards of every split leaf (`launch.sharding`)."""

    params: Any
    shifts: Any
    mean_shift: Any
    step: torch.Tensor
    opt_state: Any = ()
    pod_shifts: Any = None
    pod_mean_shift: Any = None


def configure_agg(agg: CompressedAggregation, mesh: VirtualMesh,
                  local_steps: int = 1, params=None) -> CompressedAggregation:
    """Bind an aggregation config to the mesh's wire topology: the two-level
    wire on a pod mesh (inner level over the in-pod "data" ranks, outer over
    "pod"); on a flat mesh with local steps every client its own pod (no
    inner wire, the outer level over the clients: Algorithms 4-5 exactly);
    else the single-level wire over every client. On NASTYA paths the outer
    wire carries only the slot-free epoch gradient, so its slot tables
    collapse to one row.

    The mesh's model size T goes to the wire too, and with `params` (the
    whole parameter tree; meta tensors do) each leaf's split axis
    (`launch.sharding.split_axes`), which the wire needs at T > 1."""
    pod_slots = 1 if local_steps > 1 else agg.pod_slots
    t = model_size(mesh)
    model = dict(model_size=t)
    if params is not None and t > 1:
        model["model_axes"] = sharding.split_axes(params, t)
    if pod_axes(mesh):
        return dataclasses.replace(agg, client_axes=data_axes(mesh),
                                   pod_axes=pod_axes(mesh),
                                   pod_size=num_pods(mesh),
                                   pod_slots=pod_slots, **model)
    if local_steps > 1:
        return dataclasses.replace(agg, client_axes=(),
                                   pod_axes=client_axes(mesh),
                                   pod_size=num_clients(mesh),
                                   pod_slots=pod_slots, **model)
    return dataclasses.replace(agg, client_axes=client_axes(mesh),
                               pod_axes=(), pod_size=1, **model)


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
    `mesh`; without it `agg` is used as it is), the optimizer's state.
    Where the mesh's model axis spreads over processes, the process keeps
    its shards of every split leaf (of the parameters, the tables and the
    optimizer's state)."""
    params = transformer.init_params(seed, cfg, device)
    if mesh is not None:
        agg = configure_agg(agg, mesh, local_steps, params=params)
    params = sharding.take_shards(params, agg)
    tables = agg.init(params, m) or DianaState(None, None)
    opt_state = _make_optimizer(optimizer, lr).init(params)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return TrainState(params, tables.shifts, tables.mean_shift, step,
                      opt_state, tables.pod_shifts, tables.pod_mean_shift)


def with_cohort_shifts(state: TrainState, host_shifts,
                       field: str = "shifts") -> TrainState:
    """Swap cohort-gathered shift slices into a TrainState (fleet path).

    The step runs the rule arithmetic on whatever (M, [n_slots,] *param)
    slice the state holds; under partial participation (`fleet.
    FleetRunner`) that slice is the round's cohort, gathered from the host
    `ClientStateStore`. Each slice is copied into the state's existing
    table on its device, in place (the step writes its tables in place
    too), or placed on the device of the state's parameters where the
    field holds no table yet. `host_shifts` is None for memory-free
    methods ('q'/'dense'): the state passes through untouched.

    `field` selects the table that holds the per-client state: "shifts"
    when the mesh's client ranks are the inner wire level, "pod_shifts" on
    flat NASTYA meshes (each client its own pod, so its DIANA state lives
    in the outer tables).

    Spread over processes, the state holds the process's rows of the
    table and `host_shifts` the rows of the client ranks it serves
    (`ClientStateStore.gather` over a `FleetPlacement`), its model
    shards' slices of each split leaf.
    """
    if host_shifts is None:
        return state
    if field not in ("shifts", "pod_shifts"):
        raise ValueError(f"field {field!r}; options: 'shifts', 'pod_shifts'")
    table = getattr(state, field)
    if table is None:
        dev = tree_leaves(state.params)[0].device
        new = tree_map(lambda h: h.to(dev), host_shifts)
    else:
        new = tree_map(lambda t, h: t.copy_(h), table, host_shifts)
    return state._replace(**{field: new})


def _shard_sq_sums(tree, agg, param_nd: list, lead: bool) -> torch.Tensor:
    """(rows, local shards) f32: for each of the leaves' leading rows (one
    row without `lead`) and each model shard this process holds, the sum
    of the squares of that shard of every leaf, the leaves added in order;
    a leaf that is not split counts whole in shard 0. Each shard is summed
    as a contiguous tensor, so the same row and shard give the same bits
    whether a process holds one shard or every one (0 for an empty
    tree)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return None
    shards = agg.local_shards
    n = shards.stop - shards.start
    axes = agg._leaf_axes(len(param_nd))
    rows = leaves[0].shape[0] if lead else 1
    out = []
    for i in range(rows):
        row = []
        for t in range(n):
            total = None
            for x, nd, ax in zip(leaves, param_nd, axes):
                xi = x[i] if lead else x
                if ax is None:
                    if shards.start + t != 0:
                        continue
                    part = xi
                else:
                    ax += xi.dim() - nd  # past the table's slot axis
                    size = xi.shape[ax] // n
                    part = xi.narrow(ax, t * size, size)
                sq = torch.sum(torch.square(
                    part.contiguous().to(torch.float32)))
                total = sq if total is None else total + sq
            row.append(torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                       if total is None else total)
        out.append(torch.stack(row))
    return torch.stack(out)


def _sum_partials(parts: torch.Tensor, agg, level: str | None) -> torch.Tensor:
    """The sum of (rows, local shards) partial sums over every shard and
    every row: the shards gathered over the model group and the rows over
    `level`'s processes (None: the rows are whole on every process), then
    each row's shards added in order and the rows in rank order (0 for
    no partials: an empty tree)."""
    if parts is None:
        return torch.zeros((), dtype=torch.float32)
    comm, pods = agg.collective, agg.num_pods()
    if comm.model_procs > 1:
        rows, n = parts.shape
        wm = comm.model_procs
        parts = comm.gather(parts, "model", pods).reshape(wm, rows, n)
        parts = parts.permute(1, 0, 2).reshape(rows, wm * n)
    if level is not None:
        parts = comm.gather(parts, level, pods)
    return _rank_sum(_rank_sum(parts, 1), 0)


def _local_update(xl: list, dl: list, gamma: float) -> list:
    """x <- (x_f32 - gamma * d_f32) in x's dtype, on the leaf lists of the
    pods' iterates and directions, which the caller hands over: each old
    iterate and direction leaf is released as soon as its update exists
    (at full width each tree is 13 GB), and the update holds two f32
    temporaries of a leaf, not three."""
    for i in range(len(xl)):
        xi, di = xl[i], dl[i]
        xl[i] = dl[i] = None
        step = di.to(torch.float32, copy=True).mul_(gamma)
        del di
        new = xi.to(torch.float32, copy=True).sub_(step)
        del step
        xl[i] = new.to(xi.dtype)
        del xi, new
    return xl


def _debug_extras(agg, param_nd, g_stacked, g_level, direction, new_shifts,
                  new_ms) -> dict:
    """The compression diagnostics of `debug_metrics`: ||g_mean - D||^2,
    the squared distance between the uncompressed mean of the stacked
    gradients (clients, or pods on NASTYA paths: `g_level` "world" or
    "outer") and the wire's direction, and the squared norms of the
    direction and the new shift tables. Spread over processes the dense
    gradients are gathered for the mean (a diagnostic, not the wire).
    Each sum is taken shard by shard (`_shard_sq_sums`), so it has the
    same bits however the model shards spread over processes."""
    comm, pods = agg.collective, agg.num_pods()
    shards = agg.local_shards
    n = shards.stop - shards.start
    axes = agg._leaf_axes(len(param_nd))
    err = [None] * n
    for g, d, ax in zip(tree_leaves(g_stacked), tree_leaves(direction),
                        axes):
        g = comm.gather(g.to(torch.float32), g_level, pods)
        for t in range(n):
            if ax is None:
                if shards.start + t != 0:
                    continue
                gt, dt = g, d
            else:
                size = d.shape[ax] // n
                gt = g.narrow(1 + ax, t * size, size).contiguous()
                dt = d.narrow(ax, t * size, size).contiguous()
            e = torch.sum(torch.square(torch.mean(gt, dim=0)
                                       - dt.to(torch.float32)))
            err[t] = e if err[t] is None else err[t] + e
    zero = torch.zeros((), dtype=torch.float32,
                       device=tree_leaves(direction)[0].device)
    err = torch.stack([zero if e is None else e for e in err])[None]
    units = agg.table_units()
    ms_level = "outer" if units.mean_shift == "pod" else None
    return {"compression_err_sq": _sum_partials(err, agg, None),
            "direction_norm_sq": _sum_partials(_shard_sq_sums(
                direction, agg, param_nd, False), agg, None),
            "shift_norm_sq": _sum_partials(_shard_sq_sums(
                new_shifts, agg, param_nd, True), agg, "world"),
            "mean_shift_norm_sq": _sum_partials(_shard_sq_sums(
                new_ms, agg, param_nd, ms_level is not None), agg,
                ms_level)}


def make_train_step(cfg: ArchConfig, mesh: VirtualMesh, *,
                    agg: CompressedAggregation, lr: float = 3e-3,
                    eta: float | None = None, local_steps: int = 1,
                    remat="full", ce: str = "gather", seq_shard: bool = True,
                    optimizer: str = "sgd", elastic: bool = False,
                    debug_metrics: bool = False):
    """Returns step(state, batch, gen, slots=None, weights=None, *,
    draws=None) -> (state, metrics).

    batch: {"tokens": (M * local_steps * b, S + 1) integer tensor},
    client-major (rows [c*L*b, (c+1)*L*b) are client c's, its L =
    local_steps micro-batches in turn); spread over processes, the rows
    of the process's M_local clients only. gen: a torch.Generator on the
    state's device, from which the wire draws its windows and NASTYA its
    per-pod permutations (unused for what `draws` covers, see below).
    slots: the step's shared batch indices as a (local_steps,) vector
    (`data.pipeline.shared_slots_for_step`), needed by per-slot methods
    ('diana_rr'). weights: with `elastic`, the (M,) f32 participation
    weights of every client rank (pre-normalized so full participation is
    all ones, which gives the non-elastic step bit for bit). metrics:
    {"loss", "grad_norm"},
    plus with `debug_metrics` "compression_err_sq", "direction_norm_sq",
    "shift_norm_sq" and "mean_shift_norm_sq".

    lr is the client stepsize gamma; with local_steps == 1 it is also the
    server's. With local_steps > 1 (NASTYA) `eta` is the server stepsize
    (default gamma * local_steps).

    draws: {"inner": [...], "outer": [...]} as `core.dist` takes them; on
    NASTYA paths "inner" is a list with one such leaf list per local step,
    and "perm" the (P, local_steps) micro-batch order of each pod.

    ce: the loss's cross entropy, "gather" or "streaming"
    (`transformer.loss_fn`).

    seq_shard: under remat "full" each decoder block keeps for the
    backward only the rows of its input's sequence that the process's
    model shards hold (`transformer.loss_fn(seq_shard=)`; on by default,
    as the reference's `make_train_step` has it): the stash a process
    keeps is then its share, put together again over the model group
    block by block in the backward. It changes no number.

    The step updates the state's shift tables in place (the
    reference's step donates its state); take a copy first to keep one.
    The backend of the wire's kernels is `agg.backend`, its collective
    `agg.collective`: with a process group's, the state holds the
    process's rows of the per-rank and per-pod tables and its model
    shards of the split leaves (`init_train_state` lays them out so).
    """
    if ce not in transformer._CE:
        raise ValueError(f"unknown ce {ce!r}; options: {transformer._CE}")
    if eta is not None and local_steps == 1:
        raise ValueError("eta is the NASTYA server stepsize and requires "
                         "local_steps > 1 (with one local step the server "
                         "stepsize IS lr; Algorithms 2-3)")
    if elastic and local_steps > 1:
        raise ValueError(
            "elastic=True requires local_steps == 1: a NASTYA epoch "
            "consumes a full local mini-epoch per client, so a mid-epoch "
            "straggler has no well-defined RR rewind point")
    m = num_clients(mesh)
    meta = transformer.init_params(0, cfg, "meta")
    agg = configure_agg(agg, mesh, local_steps, params=meta)
    param_nd = [p.dim() for p in tree_leaves(meta)]
    del meta
    # the layers on the process's model shards (None: T = 1, whole layers)
    ms = sharding.model_shards(agg, cfg)
    n_pods = agg.num_pods()
    per_pod = m // n_pods
    comm = agg.collective
    agg.local_shards  # the collective's mesh must have this model size
    # this process's clients and pods (all of them on one process)
    own = comm.local("rank", n_pods)
    own_pods = comm.local("pod", n_pods)
    m_local = len(range(m)[own])
    pods_local = len(range(n_pods)[own_pods])
    spread = comm.units("rank", n_pods, m_local)
    if spread != m:
        raise ValueError(f"the collective spreads {spread} client ranks, "
                         f"the mesh has {m}")
    gamma = lr
    server_lr = ((eta if eta is not None else gamma * local_steps)
                 if local_steps > 1 else lr)
    opt = _make_optimizer(optimizer, server_lr)
    stateful = agg.rule.has_shifts
    slotted = agg.rule.slotted

    def client_grads(params_of, batch_c):
        """Per-client (loss, grad): the process's clients one after
        another, (local) client c at parameters `params_of(c)` (the
        process's model shards of them), each gradient (of those shards)
        written into its row of the (M_local, *param) stack."""
        leaves, unflatten = tree_flatten(params_of(0))
        grads = [torch.empty((m_local,) + tuple(p.shape), dtype=p.dtype,
                             device=p.device) for p in leaves]
        losses = []
        for c in range(m_local):
            req = [p.detach().requires_grad_(True)
                   for p in tree_leaves(params_of(c))]
            loss = transformer.loss_fn(
                unflatten(req), tree_map(lambda x: x[c], batch_c), cfg,
                remat=remat, ce=ce, ms=ms, seq_shard=seq_shard)
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
        if rows == 0 or rows % (m_local * local_steps):
            raise ValueError(
                f"batch has {rows} leading rows, not divisible by "
                f"m*local_steps = {m_local}*{local_steps} — the step "
                "consumes client-major (m * local_steps * b)-row batches of "
                "the process's clients")

    def mean_loss(losses):
        """The mean of every rank's loss, in the stacked order."""
        return torch.mean(comm.gather(losses, "world", n_pods))

    def flat_round(state, batch, gen, slots, weights, draws):
        """One communication round (Algorithms 2-3 / the composed wire)."""
        bsz = tree_leaves(batch)[0].shape[0] // m_local
        batch_c = tree_map(
            lambda x: x.reshape((m_local, bsz) + tuple(x.shape[1:])), batch)
        losses, g = client_grads(lambda c: state.params, batch_c)
        gnorm = torch.sqrt(_sum_partials(
            _shard_sq_sums(g, agg, param_nd, True), agg, "world") / m)
        dstate = DianaState(state.shifts, state.mean_shift, state.pod_shifts,
                            state.pod_mean_shift) if stateful else None
        direction, nd = agg.aggregate(g, dstate, gen, slot=int(slots[0]),
                                      draws=draws, weight=weights)
        nd = nd or DianaState(None, None)
        extras = (_debug_extras(agg, param_nd, g, "world", direction,
                                nd.shifts, nd.mean_shift)
                  if debug_metrics else {})
        del g  # the per-client stack is the step's largest transient
        return direction, nd, mean_loss(losses), gnorm, extras

    def pod_orders(gen, draws, device):
        """Each pod's order of its local_steps micro-batches: a (P,
        local_steps) host array (Algorithm 4 line 5)."""
        if draws is not None and "perm" in draws:
            perm = np.asarray(draws["perm"], dtype=np.int64)
        else:
            # analysis: allow[trace-hazard] NASTYA indexes each pod's
            # micro-batches on the host; blocks CUDA-graph capture (ROADMAP
            # parked)
            perm = host_orders(torch.stack([
                torch.randperm(local_steps, generator=gen, device=device)
                for _ in range(n_pods)]).cpu())
        if perm.shape != (n_pods, local_steps):
            raise ValueError(f"draws['perm'] must be ({n_pods}, "
                             f"{local_steps}), got {perm.shape}")
        return perm

    def nastya_epoch(state, batch, gen, slots, draws):
        """local_steps local RR steps per pod + one outer-wire round."""
        device = tree_leaves(state.params)[0].device
        bsz = tree_leaves(batch)[0].shape[0] // (m_local * local_steps)
        batch_r = tree_map(
            lambda x: x.reshape((m_local, local_steps, bsz)
                                + tuple(x.shape[1:])), batch)
        perm = pod_orders(gen, draws, device)  # every pod's, (P, L)
        # (M_local, local_steps): the process's clients' rows
        client_perm = np.repeat(perm, per_pod, axis=0)[own]
        rows = torch.arange(m_local, device=device)
        # local client c's pod among the process's pods
        pod_of = [(c + own.indices(m)[0]) // per_pod
                  - own_pods.indices(n_pods)[0] for c in range(m_local)]
        # x_pods: each (local) pod's iterate, (P_local, *param); the pods
        # start together
        x = tree_map(lambda p: p.expand((pods_local,) + tuple(p.shape)),
                     state.params)
        shifts, mean_shift = state.shifts, state.mean_shift
        losses = []
        for t in range(local_steps):
            cols = torch.as_tensor(client_perm[:, t], device=device)
            batch_t = tree_map(lambda b: b[rows, cols], batch_r)
            # client c works on its pod's iterate: the reference's
            # jnp.repeat of the pod stack, read in place
            step_losses, g = client_grads(
                lambda c: tree_map(lambda xi: xi[pod_of[c]], x), batch_t)
            inner = None if draws is None else {"inner": draws["inner"][t]}
            dstate = DianaState(shifts, mean_shift) if stateful else None
            direction, nd = agg.aggregate_local(
                g, dstate, gen, slot=slots[perm[:, t]], draws=inner)
            del g
            if stateful:
                shifts, mean_shift = nd.shifts, nd.mean_shift
            # hand both trees over as leaf lists: no name here keeps an old
            # iterate or a direction alive while the update runs
            xl, unflatten_x = tree_flatten(x)
            dl = tree_leaves(direction)
            del x, direction
            x = unflatten_x(_local_update(xl, dl, gamma))
            del xl, dl
            losses.append(mean_loss(step_losses))
        # g_pod = (x_t - x_t^n) / (gamma * n)   (Alg. 4/5 line 7); each
        # pod iterate is freed as soon as its epoch gradient exists
        divisor = torch.tensor(gamma * local_steps, dtype=torch.float32,
                               device=device)
        leaves, unflatten = tree_flatten(x)
        del x
        g_pod = []
        for p, i in zip(tree_leaves(state.params), range(len(leaves))):
            xn, leaves[i] = leaves[i], None
            g = p.to(torch.float32)[None] - xn.to(torch.float32)
            del xn
            g_pod.append(g.div_(divisor))
        g_pod = unflatten(g_pod)
        gnorm = torch.sqrt(_sum_partials(
            _shard_sq_sums(g_pod, agg, param_nd, True), agg, "outer")
            / n_pods)
        dstate = DianaState(None, None, state.pod_shifts,
                            state.pod_mean_shift) if stateful else None
        direction, nd = agg.aggregate_pod(
            g_pod, dstate, gen,
            draws=None if draws is None else {"outer": draws["outer"]})
        nd = DianaState(shifts, mean_shift,
                        nd.pod_shifts if stateful else None,
                        nd.pod_mean_shift if stateful else None)
        extras = (_debug_extras(agg, param_nd, g_pod, "outer", direction,
                                nd.shifts, nd.mean_shift)
                  if debug_metrics else {})
        return direction, nd, torch.mean(torch.stack(losses)), gnorm, extras

    def step(state: TrainState, batch, gen, slots=None, weights=None, *,
             draws=None):
        check_batch(batch)
        if slots is None:
            if slotted:
                raise ValueError(
                    f"method {agg.method!r} keeps per-slot shift tables: "
                    "pass the step's shared slots (slots, a (local_steps,) "
                    "vector; see data.pipeline.shared_slots_for_step)")
            slots = np.zeros((local_steps,), np.int64)
        slots = np.asarray(slots)
        if slots.shape != (local_steps,):
            raise ValueError(f"slots must be a ({local_steps},) vector of "
                             f"shared batch indices, got {slots.shape}")
        if elastic:
            if weights is None or tuple(weights.shape) != (m,):
                raise ValueError(
                    f"elastic weights must be an ({m},) f32 vector (one "
                    "participation weight per client rank), got "
                    f"{None if weights is None else tuple(weights.shape)}")
            # the weights of this process's ranks
            weights = torch.as_tensor(
                weights, dtype=torch.float32,
                device=tree_leaves(state.params)[0].device)[own]
        elif weights is not None:
            raise ValueError("weights are the elastic step's: build the "
                             "step with elastic=True")
        if local_steps > 1:
            direction, nd, loss, gnorm, extras = nastya_epoch(
                state, batch, gen, slots, draws)
        else:
            direction, nd, loss, gnorm, extras = flat_round(
                state, batch, gen, slots, weights, draws)
        updates, new_opt = opt.update(
            tree_map(lambda d: d.to(torch.float32), direction),
            state.opt_state, state.params)
        new_params = optim.apply_updates(state.params, updates)
        metrics = {"loss": loss, "grad_norm": gnorm, **extras}
        return TrainState(new_params, nd.shifts, nd.mean_shift,
                          state.step + 1, new_opt, nd.pod_shifts,
                          nd.pod_mean_shift), metrics

    return step


def serve_shards(cfg: ArchConfig, mesh: VirtualMesh, cache_len: int,
                 collective=None, batch: int | None = None
                 ) -> tp.ModelShards:
    """The model shards a process's serve steps compute on for a batch of
    `batch` requests (by default one a client rank): its shards of each
    split parameter leaf (`sharding.split_axes` at T) and its slice of
    each cache leaf (`sharding.cache_axes`: its clients' rows and its
    shards where the clients share the batch, else its joint parts, its
    shards or the whole leaf), over `collective`'s "model" and "joint"
    groups (one process, holding every cell, by default)."""
    t = model_size(mesh)
    comm = collective or distributed.StackedCollective()
    shards = comm.local_shards(t)
    whole = transformer.init_params(0, cfg, "meta")
    layout = sharding.cache_axes(cfg, cache_len, mesh, batch)
    m, pods = num_clients(mesh), num_pods(mesh)
    joint = tp.Parts(m * t, tuple(comm.joint_parts(m, t, pods)), comm, pods,
                     "joint", tuple(comm.joint_order(m, t, pods)))
    return tp.ModelShards(
        t, axes=sharding.split_axes(whole, t), start=shards.start,
        count=shards.stop - shards.start, comm=comm, pods=pods,
        cache_axes=tuple(s.axis for s in layout),
        cache_joint=tuple(s.joint for s in layout), joint=joint)


class _Layouts(dict):
    """A step's `serve_shards` for each count of rows it has been given.
    Given `batch` (the requests of every client), the rows are a
    process's share of it where the clients share it, else all of it;
    without, they are the batch itself where one process holds every
    client rank (or only the model shards spread), else a share."""

    def __init__(self, cfg, mesh, cache_len, collective, batch):
        super().__init__()
        self.args = (cfg, mesh, cache_len, collective)
        self.comm = collective or distributed.StackedCollective()
        self.batch = batch
        self.clients = num_clients(mesh)
        self.local = len(range(self.clients)[
            self.comm.local("rank", num_pods(mesh))])

    def whole(self, b: int) -> bool:
        """Whether b rows are a batch every client serves whole."""
        if self.batch is not None:
            whole = not sharding.batch_shared(self.batch, self.clients)
            share = (self.batch if whole
                     else self.batch // self.clients * self.local)
            if b != share:
                raise ValueError(
                    f"{b} rows given, the step serves {share} of a batch "
                    f"of {self.batch} over {self.clients} client ranks")
            return whole
        if self.comm.world // self.comm.model_procs > 1:
            return False
        return not sharding.batch_shared(b, self.clients)

    def __missing__(self, b):
        cfg, mesh, cache_len, collective = self.args
        ms = self[b] = serve_shards(cfg, mesh, cache_len, collective,
                                    b if self.whole(b) else None)
        return ms

    def rows(self, b: int) -> int | None:
        """Each of the process's clients' rows of b, or None where every
        client serves all b (`cache_specs`' joint layout)."""
        return None if self.whole(b) else b // self.local


def _rows(cache, lo: int, n: int):
    """Rows [lo, lo + n) of every cache leaf (L, B, ...), as views."""
    return tree_map(lambda x: x.narrow(1, lo, n), cache)


def make_prefill_step(cfg: ArchConfig, mesh: VirtualMesh | None = None, *,
                      cache_len: int, collective=None,
                      batch: int | None = None):
    """Returns prefill(params, batch) -> (last-token logits (B, 1, Vp),
    cache stacked over layers), `transformer.prefill` at `cache_len`.

    With a mesh of T > 1 model shards (the reference places the
    parameters by `param_specs` and the cache by `cache_specs`) the
    process computes on its shards: `params` are its shards of the
    parameters (`sharding.take_model_shards`; the whole tree on one
    process). Where the client ranks share the batch (B >= clients and
    divisible), `batch` is its clients' rows, each client's prefilled on
    their own, as a process holding that client alone does; else `batch`
    is the whole batch, which every client serves, prefilled once by
    model shard (every client's copy has the same bits). Where the
    client ranks spread over processes, the factory's `batch` (B, every
    client's requests) says which: without it the rows are a share of a
    batch the clients share. The cache
    returned is the process's slice (its rows and shards, or its joint
    parts: `transformer.init_cache(..., shards=)`). A mesh of one model
    shard, or none, is the whole-layer path. The reference's factory also
    returns `lower_args`; the port returns the step alone, as
    `make_train_step` does."""
    if mesh is None or model_size(mesh) == 1:
        def prefill(params, batch):
            return transformer.prefill(params, batch, cfg,
                                       cache_len=cache_len)

        return prefill
    layouts = _Layouts(cfg, mesh, cache_len, collective, batch)

    def prefill_tp(params, batch):
        b = batch["tokens"].shape[0]
        ms, r = layouts[b], layouts.rows(b)
        if r is None:
            return transformer.prefill(params, batch, cfg,
                                       cache_len=cache_len, ms=ms)
        logits, caches = [], []
        for lo in range(0, b, r):
            lg, cache = transformer.prefill(
                params, tree_map(lambda x: x[lo:lo + r], batch), cfg,
                cache_len=cache_len, ms=ms)
            logits.append(lg)
            caches.append(cache)
        if len(caches) == 1:
            return logits[0], caches[0]
        leaves = [tree_leaves(c) for c in caches]
        _, unflatten = tree_flatten(caches[0])
        del caches
        return torch.cat(logits), unflatten(
            [torch.cat(xs, dim=1) for xs in zip(*leaves)])

    prefill_tp.shards = serve_shards(cfg, mesh, cache_len, collective)
    prefill_tp.layouts = layouts
    return prefill_tp


def make_serve_step(cfg: ArchConfig, mesh: VirtualMesh | None = None, *,
                    cache_len: int | None = None, collective=None,
                    batch: int | None = None):
    """Returns serve(params, cache, tokens, pos) -> (logits (B, 1, Vp),
    cache): one token of every request, `transformer.decode_step`.

    The step writes the token into `cache` in place and returns that same
    cache (the reference's step donates it); take a copy first to keep
    the old one. With a mesh of T > 1 model shards the process decodes its
    clients' rows, each client's on its own, or the whole batch once where
    the clients do not share it (the tokens replicated, as the
    reference's `P()` places them), on its shards of the parameters and
    its slice of the cache (`make_prefill_step`'s; the slice's layout
    needs the cache's `cache_len`). No `lower_args`: see
    `make_prefill_step`."""
    if mesh is None or model_size(mesh) == 1:
        def serve(params, cache, tokens, pos):
            return transformer.decode_step(params, cache, tokens, pos, cfg)

        return serve
    if cache_len is None:
        raise ValueError("a serve step on a mesh of model shards needs the "
                         "cache's cache_len (its layout: cache_specs)")
    layouts = _Layouts(cfg, mesh, cache_len, collective, batch)

    def serve_tp(params, cache, tokens, pos):
        b = tokens.shape[0]
        ms, r = layouts[b], layouts.rows(b)
        if r is None:
            return transformer.decode_step(params, cache, tokens, pos, cfg,
                                           ms=ms)
        logits = [transformer.decode_step(
            params, _rows(cache, lo, r), tokens[lo:lo + r], pos, cfg,
            ms=ms)[0] for lo in range(0, b, r)]
        return torch.cat(logits), cache

    serve_tp.shards = serve_shards(cfg, mesh, cache_len, collective)
    serve_tp.layouts = layouts
    return serve_tp
