"""Production compressed-gradient aggregation over rank-stacked trees
(port of `repro.core.dist`).

The reference runs the wire inside a `shard_map` over the mesh: each device
holds one client rank's gradient block and `lax.pmean` over the level's
axes is the server. Here every gradient and shift tree carries a leading
rank dimension: all R = P * C ranks (P pods of C clients, pod-major, as
the reference's mesh enumerates them) on one process, or a process's
R_local of them when the ranks are spread over processes
(`launch.distributed`). Then:

- `all_gather` is the agg's `collective`: the identity on one process
  (`StackedCollective`, the default), a process-group gather otherwise;
  it gathers each level's compressed message, never a dense gradient
  (but for the dense method and the independent wire, dense in the
  reference too);
- `lax.pmean` over a level is `backend.level_mean` (or the packed
  transports' `unpack_reduce`) over the gathered rank dimension (ranks
  accumulated in order, then / R): every process reduces the same bits;
- a two-level (pod) wire is a reshape of the ranks into (pods, C).

Two wire modes, as in the reference:

``shared``
    Every rank of a level draws the SAME window of whole BLOCK_ROWS-row
    blocks ("Rand-block") from the row view of each leaf, so only the k-row
    slab is exchanged. One draw per leaf per level: the window start stays
    a device scalar, and the whole (R, N, D) stack is gathered
    (`randk_compress`) and scattered back (`randk_decompress`) in one launch
    each. The slab's transport (`wire_dtype`) is 'f32' (with `wire_levels`
    quantized through the pack -> unpack pair, `pack_slab` / `unpack_slab`,
    with shared uniforms), 'bf16', or the byte lattices 'packed8' /
    'packed4': packed once, the own slab decoded (`unpack_slab`), and each
    group's mean formed from the stacked bytes by `unpack_reduce`.
``independent``
    Every rank draws its own with-replacement rows (paper-exact, dense
    collective): plain torch, `index_add_` into a zero canvas, or set
    semantics for the contractive (error feedback) projection.

Methods and their shift rules (`core.rules.WIRE_RULES`): ``dense`` (plain
mean), ``q`` (NoShift), ``diana`` (SingleShift), ``diana_rr`` (PerSlotShift,
the round's shared slot picks the table row) and ``ef`` (EfRule).

State layout (`DianaState`, stacked): `shifts` (R, [n_slots,] *param);
`mean_shift` (P, [n_slots,] *param) on pod layouts, else ([n_slots,]
*param); `pod_shifts` (P, [n_slots,] *param); `pod_mean_shift` ([n_slots,]
*param). Spread over processes, each holds its own rows of the per-rank
and per-pod tables (`table_units`) and the rest whole. Every table is
written in place (the reference's step donates its state): a round holds
one copy of the tables, not an old and a new one (13 GB of the
full-width DIANA-NASTYA step's pod tables).

Elastic weights: `aggregate(..., weight=w)` with w (R,) f32 scales each
rank's compressed message into the collective mean (never its own message)
at the client-granular level: the inner level when `client_axes` is set,
else the outer one. The transports fold it where the reference does:
((b - L) * s) * w on the f32 wire, (b - L) * (s * w) on the packed ones.

Per-group slots: per-slot methods take the round's slot as an int (every
group the same) or as a (groups,) vector, one slot per pod (NASTYA's local
steps, where each pod walks its own permutation of the slots).

The model axis: with `model_size` T > 1 each leaf split over the mesh's
model shards (`model_axes`, from `launch.sharding`) is exchanged shard by
shard, as each model shard of the reference exchanges its local block
inside the `shard_map`: its own row view and padding, its own packed
scales, level means and rule update, and the leaf's one draw (the start
and the uniforms drawn from one shard's geometry, or the independent
wire's indices: the reference draws them from the same key on every
shard). Replicated leaves are exchanged whole. The leaves stay whole (or
hold a process's shards, when the model axis spreads over processes), and
the kernels run at the shard shapes, one launch per shard.

Draws come from the caller's `torch.Generator`, in leaf order per level
(inner level first): the window start, then the rounding uniforms when the
slab is quantized (`wire_levels` or a packed transport), or the independent
wire's (R, k) row indices. Every process draws every rank's draws, in the
stacked order, and keeps its own rows. A test injects the reference's
draws through `draws={"inner": [...], "outer": [...]}`, one dict per leaf
with keys "start", "quant_u" or "idx".
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.compression.backend import (
    BLOCK_ROWS,
    WIRE_DTYPES,
    get_backend,
    level_mean,
)
from repro_torch.core.api import tree_flatten, tree_leaves, tree_map
from repro_torch.core.rules import WIRE_RULES, EfRule, ShiftRule
from repro_torch.kernels.ref import randk_scale
from repro_torch.launch.distributed import StackedCollective

# Biased-byte representation caps: 2 * levels + 1 lattice points must fit
# the lane (256 byte values / 16 nibble values).
_WIRE_LEVEL_CAPS = {"packed8": 127, "packed4": 7}


def payload_itemsize(wire_dtype: str, rule: ShiftRule,
                     leaf_dtype=torch.float32) -> float:
    """Bytes per slab element one rank puts on the shared wire: the single
    accounting authority of the wire's transport width. Stateful rules move
    f32 payloads on the f32 transport; memory-free 'q' slabs travel at the
    leaf's dtype; bf16 halves the lane; packed8 / packed4 move one byte per
    one / two elements (their f32 scale sideband is counted apart)."""
    if wire_dtype == "bf16":
        return 2
    if wire_dtype == "packed8":
        return 1
    if wire_dtype == "packed4":
        return 0.5
    return 4 if rule.has_shifts else leaf_dtype.itemsize


def scale_sideband_bytes(wire_dtype: str, slab_rows: int) -> int:
    """Bytes of the packed wire's f32 per-row scale sideband (0 otherwise)."""
    if wire_dtype in _WIRE_LEVEL_CAPS:
        return 4 * slab_rows
    return 0


class DianaState(NamedTuple):
    """Rank-stacked compression state (see the module docstring for the
    layouts). Unused levels hold None."""

    shifts: Any
    mean_shift: Any
    pod_shifts: Any = None
    pod_mean_shift: Any = None


def _row_view(x: torch.Tensor) -> torch.Tensor:
    """(R, *shape) -> (R, rows, cols): rows = prod(shape[:-1]) and
    cols = shape[-1] for >= 2-D leaves, (numel, 1) for vectors."""
    if x.dim() >= 3:
        return x.reshape(x.shape[0], -1, x.shape[-1])
    return x.reshape(x.shape[0], -1, 1)


def _pad_rows(rows: torch.Tensor) -> torch.Tensor:
    pad = (-rows.shape[1]) % BLOCK_ROWS
    return F.pad(rows, (0, 0, 0, pad)) if pad else rows


@dataclasses.dataclass(frozen=True)
class CompressedAggregation:
    """Config + functions of the production gradient wire."""

    method: str = "diana"  # 'dense' | 'q' | 'diana' | 'diana_rr' | 'ef'
    wire: str = "shared"  # 'shared' | 'independent'
    fraction: float = 0.02  # k/d on the inner (intra-pod) wire
    alpha: float | None = None  # shift stepsize; None -> 1/(1+omega)
    shift_dtype: Any = torch.bfloat16
    n_slots: int = 1  # per-slot shift-table rows ('diana_rr': the data n)
    client_axes: tuple[str, ...] = ("data",)  # inner level (ranks in a pod)
    pod_axes: tuple[str, ...] = ()  # outer level; () = flat single-level wire
    pod_size: int = 1  # number of pods (1 = no inter-pod link)
    pod_fraction: float | None = None  # inter-pod k/d; None -> fraction
    pod_alpha: float | None = None  # pod shift stepsize; None -> 1/(1+omega_pod)
    pod_slots: int | None = None  # outer-level slot rows; None -> n_slots
    mean_scale: float = 1.0  # beta = mean_scale * alpha at the client level
    backend: str | None = None  # 'cuda' | 'reference' | None (= 'cuda')
    wire_dtype: str = "f32"  # slab transport: WIRE_DTYPES
    wire_levels: int | None = None  # stochastic-quantization levels
    model_size: int = 1  # T: the mesh's model shards of each client
    # each leaf's axis split over the T shards (param coordinates, in
    # tree_flatten order; None: replicated), from `launch.sharding`
    model_axes: tuple | None = None
    # the wire's all_gather (launch.distributed): the identity on one
    # process; it also counts the bytes each level sends
    collective: Any = dataclasses.field(default_factory=StackedCollective,
                                        compare=False, repr=False)

    def __post_init__(self):
        if self.method not in WIRE_RULES:
            raise ValueError(f"unknown method {self.method!r}; options: "
                             f"{sorted(WIRE_RULES)}")
        if self.wire not in ("shared", "independent"):
            raise ValueError(f"unknown wire {self.wire!r}; options: "
                             "('shared', 'independent')")
        if self.n_slots < 1:
            raise ValueError(f"n_slots={self.n_slots}")
        if self.model_size < 1:
            raise ValueError(f"model_size={self.model_size}")
        if self.pod_slots is not None and self.pod_slots < 1:
            raise ValueError(f"pod_slots={self.pod_slots}")
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"unknown wire_dtype {self.wire_dtype!r}; "
                             f"options: {WIRE_DTYPES}")
        if self.wire_dtype != "f32" or self.wire_levels is not None:
            if self.method == "dense":
                raise ValueError(
                    "method 'dense' has no compressed slab; wire_dtype must "
                    "stay 'f32' with wire_levels=None")
            if self.wire != "shared":
                raise ValueError(
                    "bf16/packed/quantized transport needs the shared wire "
                    f"(wire={self.wire!r} moves dense leaves, not slabs)")
        if self.wire_dtype == "bf16" and self.wire_levels is not None:
            raise ValueError(
                "wire_levels with bf16 transport is ambiguous (quantize to a "
                "lattice, then round the lattice to bf16?) — pick one of "
                "'f32'+levels (QSGD wire) or plain 'bf16'")
        cap = _WIRE_LEVEL_CAPS.get(self.wire_dtype)
        if self.wire_levels is not None:
            if self.wire_levels < 1:
                raise ValueError(f"wire_levels={self.wire_levels}")
            if self.wire_levels > (cap or 127):
                raise ValueError(
                    f"wire_levels={self.wire_levels} overflows the "
                    f"{self.wire_dtype} lattice: 2*levels+1 points must fit "
                    f"a byte, so levels <= {cap or 127}")

    @property
    def _quant_levels(self) -> int | None:
        """Effective quantization level count (packed lanes default full)."""
        if self.wire_levels is not None:
            return self.wire_levels
        return _WIRE_LEVEL_CAPS.get(self.wire_dtype)

    @property
    def _pod_slots(self) -> int:
        return self.n_slots if self.pod_slots is None else self.pod_slots

    @property
    def _pod_fraction(self) -> float:
        return self.fraction if self.pod_fraction is None else self.pod_fraction

    @property
    def local_shards(self) -> slice:
        """The model shards of each client this process holds (all T on
        one process, or where it holds whole clients)."""
        return self.collective.local_shards(self.model_size)

    @property
    def rule(self) -> ShiftRule:
        """The method's shift rule (`core.rules`)."""
        return WIRE_RULES[self.method]

    def num_pods(self) -> int:
        """Outer-level ranks: pod_size on a two-level wire, else 1."""
        return self.pod_size if self.pod_axes else 1

    # -- state ---------------------------------------------------------------

    def init(self, params, num_ranks: int) -> DianaState | None:
        """Zero tables for the `num_ranks` client ranks (None for
        'q'/'dense'): this process's rows of the per-rank and per-pod
        tables. `params` is one rank's (unstacked) parameter tree."""
        rule = self.rule
        if not rule.has_shifts:
            return None
        inner, outer = bool(self.client_axes), bool(self.pod_axes)
        pods = self.num_pods()
        ranks = len(range(num_ranks)[self.collective.local("rank", pods)])
        own_pods = len(range(pods)[self.collective.local("pod", pods)])

        def mk(lead, ns):
            return rule.init_shifts(params, lead, n_slots=ns,
                                    dtype=self.shift_dtype)

        return DianaState(
            shifts=mk(ranks, self.n_slots) if inner else None,
            mean_shift=(mk(own_pods if outer else None, self.n_slots)
                        if inner and rule.has_mean else None),
            pod_shifts=mk(own_pods, self._pod_slots) if outer else None,
            pod_mean_shift=(mk(None, self._pod_slots)
                            if outer and rule.has_mean else None),
        )

    def table_units(self) -> DianaState:
        """What each table's leading rows are: "rank" (one a client
        rank), "pod" (one a pod) or None (no such rows: the table is whole
        on every process). The rule `init` lays the tables out by, and
        `launch.sharding` gathers and splits checkpoints by."""
        inner, outer = bool(self.client_axes), bool(self.pod_axes)
        return DianaState(shifts="rank" if inner else None,
                          mean_shift="pod" if inner and outer else None,
                          pod_shifts="pod" if outer else None,
                          pod_mean_shift=None)

    def omega(self) -> float:
        if self.method == "dense":
            return 0.0
        return 1.0 / self.fraction - 1.0

    def pod_omega(self) -> float:
        if self.method == "dense" or self.pod_size == 1:
            return 0.0
        return 1.0 / self._pod_fraction - 1.0

    @property
    def shift_lr(self) -> float:
        """alpha <= 1/(1+omega) (Theorem 2 / 4 condition)."""
        if self.alpha is not None:
            return self.alpha
        return 1.0 / (1.0 + self.omega())

    @property
    def pod_shift_lr(self) -> float:
        if self.pod_alpha is not None:
            return self.pod_alpha
        return 1.0 / (1.0 + self.pod_omega())

    def _beta(self, alpha: float) -> float | None:
        """Mean-table stepsize for the client-granular level (None = alpha)."""
        if self.mean_scale == 1.0:
            return None
        return self.mean_scale * alpha

    # -- aggregation ----------------------------------------------------------

    def aggregate(self, grads, state: DianaState | None, gen, *, slot=None,
                  draws=None, weight=None):
        """(direction, new_state) for the rank-stacked `grads` (leaves
        (R, *param), or this process's (R_local, *param) rows). The
        direction is param-shaped: every rank of the reference ends the
        round with the same one.

        The inner level runs over the C ranks of each pod, then the outer
        level over the P pods. `slot` is the round's shared batch index
        (an int) for per-slot methods; `gen` a torch.Generator on the
        gradients' device (unused where `draws` covers every leaf).
        `weight` is the f32 vector of the (local) ranks' participation
        weights (None: unweighted), applied at the client-granular level.
        """
        if self.method == "dense":
            pods = self.num_pods()
            return tree_map(lambda g: level_mean(self.collective.gather(
                _weighted(g, weight), "world", pods, key="dense")),
                grads), state
        cw = weight if self.client_axes else None
        pw = None if self.client_axes else weight
        direction, state = self.aggregate_local(grads, state, gen, slot=slot,
                                                draws=draws, weight=cw)
        return self.aggregate_pod(direction, state, gen, slot=slot,
                                  draws=draws, weight=pw)

    def aggregate_local(self, grads, state, gen, *, slot=None, draws=None,
                        weight=None):
        """Inner level of a compressed method: (R, *param) rank-stacked ->
        (P, *param) pod-stacked directions, and the state with new inner
        tables. `slot` may be a (P,) vector: each pod's own slot."""
        if not self.client_axes:  # a pod of one client: no intra-pod wire
            return grads, state
        rule = self.rule
        dirs, new_h, new_mh = self._level(
            grads, state.shifts if rule.has_shifts else None,
            state.mean_shift if rule.has_mean else None, gen,
            level="inner", mean_lead=bool(self.pod_axes),
            fraction=self.fraction, alpha=self.shift_lr,
            beta=self._beta(self.shift_lr), slot=slot, weight=weight,
            draws=None if draws is None else draws["inner"])
        if rule.has_shifts:
            state = state._replace(shifts=new_h, mean_shift=new_mh)
        return dirs, state

    def aggregate_pod(self, direction, state, gen, *, slot=None, draws=None,
                      weight=None):
        """Outer level: (P, *param) pod-stacked -> param-shaped direction.
        A single pod has no inter-pod link: the exchange is the exact mean
        over one rank, the identity, which is what makes the 1-pod two-level
        wire bit-match the flat wire. With a per-slot method and no slot
        (the NASTYA epoch gradient) the tables' row 0 is used."""
        if not self.pod_axes:
            return tree_map(lambda d: d[0], direction), state
        if self.pod_size == 1:
            return tree_map(lambda d: level_mean(_weighted(d, weight)),
                            direction), state
        rule = self.rule
        dirs, new_h, new_mh = self._level(
            direction, state.pod_shifts if rule.has_shifts else None,
            state.pod_mean_shift if rule.has_mean else None, gen,
            level="outer", mean_lead=False, fraction=self._pod_fraction,
            alpha=self.pod_shift_lr,
            beta=self._beta(self.pod_shift_lr) if not self.client_axes
            else None,
            slot=slot, weight=weight,
            draws=None if draws is None else draws["outer"])
        if rule.has_shifts:
            state = state._replace(pod_shifts=new_h, pod_mean_shift=new_mh)
        return tree_map(lambda d: d[0], dirs), state

    # -- one exchange level ----------------------------------------------------

    def _leaf_axes(self, n_leaves: int) -> tuple:
        """Each leaf's split axis (in param coordinates) at this model
        size: None throughout at T = 1."""
        if self.model_size == 1:
            return (None,) * n_leaves
        if self.model_axes is None or len(self.model_axes) != n_leaves:
            raise ValueError(
                f"the wire at {self.model_size} model shards needs each of "
                f"its {n_leaves} leaves' split axis (model_axes, set by "
                "launch.steps.configure_agg from the parameters), got "
                f"{self.model_axes}")
        return self.model_axes

    def _level(self, grads, h_tree, mh_tree, gen, *, level: str,
               mean_lead: bool, fraction: float, alpha: float,
               beta: float | None, slot, weight, draws):
        """One compressed exchange: Q per rank, the level mean within each
        group, the rule's update. The "inner" level's groups are the pods
        (this process's pods, when spread), each over its C ranks; the
        "outer" level is one group over the P pods.

        grads leaves (R, *param), R = groups * C, or this process's rows;
        h_tree leaves (R, [ns,] *param); mh_tree leaves (groups, [ns,]
        *param) if `mean_lead`, else ([ns,] *param) with groups == 1.
        `slot` is None, an int, or a vector of every group's slot; `weight`
        None or one per (local) rank. Returns (directions (groups, *param)
        in the gradients' dtype, new h_tree, new mh_tree).

        A leaf split over the model axis is exchanged shard by shard, as
        each model shard of the reference exchanges its own block: every
        shard is row-viewed and padded on its own and uses the leaf's one
        draw (the window start and the rounding uniforms, or the
        independent wire's indices), drawn from one shard's geometry; the
        packed scales, the level means and the rule's update are the
        shard's own. The tables are written in place, shard by shard.
        """
        rule = self.rule
        pods = self.num_pods()
        groups = (len(range(pods)[self.collective.local("pod", pods)])
                  if level == "inner" else 1)
        leaves, unflatten = tree_flatten(grads)
        axes = self._leaf_axes(len(leaves))
        shards = self.local_shards
        n_shards = shards.stop - shards.start
        leaf_draws = draws if draws is not None else [None] * len(leaves)
        if h_tree is None:  # memory-free ('q'): direction = mean_r Q(g_r)
            out = []
            for g, d, ax in zip(leaves, leaf_draws, axes):
                views = _shard_views(g, ax, n_shards)
                d = self._draw(views[0].shape, level, fraction, gen, d,
                               g.device)
                dirs = [self._exchange(v, level, groups, d, fraction,
                                       weight=weight)[1].to(g.dtype)
                        for v in views]
                out.append(_join(dirs, ax))
            return unflatten(out), None, None

        slotted = rule.slotted
        if level == "inner" and np.ndim(slot) > 0:  # each pod's own slot
            slot = np.asarray(slot).reshape(-1)[
                self.collective.local("pod", pods)]
        idx, mean_idx = _slot_index(slot, groups, leaves[0].shape[0],
                                    mean_lead, leaves[0].device)
        h_leaves = tree_leaves(h_tree)
        mh_leaves = (tree_leaves(mh_tree) if mh_tree is not None
                     else [None] * len(leaves))
        dirs = []
        for g, ht, mht, d, ax in zip(leaves, h_leaves, mh_leaves, leaf_draws,
                                     axes):
            views = _shard_views(g, ax, n_shards)
            d = self._draw(views[0].shape, level, fraction, gen, d,
                           g.device)
            # the tables' shards: the same axis past their lead dims
            h_views = _shard_views(ht, ax, n_shards, ht.dim() - g.dim() + 1)
            mh_views = ([None] * len(views) if mht is None else _shard_views(
                mht, ax, n_shards, mht.dim() - g.dim() + 1))
            out = [self._leaf_update(v, hv, mhv, d, level=level,
                                     groups=groups, fraction=fraction,
                                     alpha=alpha, beta=beta, idx=idx,
                                     mean_idx=mean_idx, weight=weight)
                   for v, hv, mhv in zip(views, h_views, mh_views)]
            dirs.append(_join(out, ax))
            del out
        return (unflatten(dirs), h_tree, mh_tree)

    def _leaf_update(self, g, ht, mht, draw, *, level, groups, fraction,
                     alpha, beta, idx, mean_idx, weight):
        """One leaf (or one shard of it) of a stateful level: the payload,
        the exchange, the rule's update; writes the new rows into the
        tables `ht` / `mht` (views of the state's tables) and returns the
        direction (groups, *shape) in g's dtype."""
        rule = self.rule
        slotted = rule.slotted
        # the rule works on (groups, C, n) rank rows beside (groups, n)
        # group rows: the layout of the fused DIANA kernel
        per_rank = (groups, g.shape[0] // groups, -1)
        h = (rule.select(ht, idx) if slotted else ht).reshape(per_rank)
        # the payload in f32 (a bf16 h upcasts inside the subtract)
        p = rule.payload(g.to(torch.float32).reshape(per_rank), h)
        q_own, q_mean = self._exchange(p.reshape(g.shape), level, groups,
                                       draw, fraction,
                                       contractive=rule.contractive,
                                       weight=weight)
        if not isinstance(rule, EfRule):
            # only error feedback reads the payload back (its memory is
            # p - Q(p)); free it before the update's outputs arrive
            p = None
        mh = None
        if mht is not None:
            mh = (rule.select(mht, mean_idx) if slotted else mht)
            mh = mh.reshape(groups, -1).contiguous()
        direction, h_new, mh_new = rule.update(
            h.contiguous(), q_own.reshape(per_rank), mh,
            q_mean.reshape(groups, -1), alpha=alpha, beta=beta,
            backend=get_backend(self.backend), payload=p)
        # this leaf's canvases must not outlive it: the next leaf's
        # exchange would hold both (4 GB each at full width)
        del q_own, q_mean, h, mh
        _in_place(ht, rule.scatter(ht, idx,
                                   h_new.to(ht.dtype).reshape(g.shape)))
        del h_new
        if mht is not None:
            view = mht[mean_idx] if slotted else mht
            _in_place(mht, rule.scatter(
                mht, mean_idx, mh_new.to(mht.dtype).reshape(view.shape)))
        return direction.to(g.dtype).reshape(groups, *g.shape[1:])

    def _draw(self, shape, level: str, fraction: float, gen, draw,
              device) -> dict:
        """One leaf's draws at one level, from the geometry of a (shard of
        the) rank-stacked leaf of `shape`, on `device` from `gen`:
        the shared wire's window start and, when the slab is quantized,
        its rounding uniforms (K, D); the independent wire's (units, k)
        row indices of every rank (or pod) of the level. What `draw`
        (injected) holds is taken as it is."""
        draw = dict(draw or {})
        rows, cols = _row_geometry(shape[1:])
        if self.wire == "independent":
            if draw.get("idx") is None:
                pods = self.num_pods()
                unit = "rank" if level == "inner" else "pod"
                draw["idx"] = torch.randint(
                    0, rows, (self.collective.units(unit, pods, shape[0]),
                              max(1, int(fraction * rows))),
                    generator=gen, device=device)
            return draw
        nb, kb = _wire_geometry(rows + (-rows) % BLOCK_ROWS, fraction)
        if draw.get("start") is None:
            draw["start"] = torch.randint(0, nb, (), generator=gen,
                                          dtype=torch.int32, device=device)
        if self._quant_levels is not None and draw.get("quant_u") is None:
            draw["quant_u"] = torch.rand((kb * BLOCK_ROWS, cols),
                                         generator=gen, device=device)
        return draw

    def _exchange(self, delta, level, groups, draw, fraction,
                  contractive=False, weight=None):
        exchange = (self._exchange_shared if self.wire == "shared"
                    else self._exchange_independent)
        return exchange(delta, level, groups, draw, fraction,
                        contractive=contractive, weight=weight)

    # shared-seed Rand-block: the sparse collective --------------------------

    def _exchange_shared(self, delta, level: str, groups: int, draw,
                         fraction: float, contractive: bool = False,
                         weight=None):
        """Shared-window Rand-block exchange of one rank-stacked leaf delta
        (R, *param) with the leaf's `draw` (`_draw`). Returns (q_own (R,
        *param), q_mean (groups, *param)) dense reconstructions; both reuse
        the one start block. `weight` (R,) scales each rank's slab into the
        mean only. Every process draws the same start and uniforms; the
        level's collective gathers the slab messages."""
        be = get_backend(self.backend)
        # a shard's row view of a leaf split on its last axis is a strided
        # view; the kernels take contiguous rows
        rows = _pad_rows(_row_view(delta)).contiguous()
        nb, kb = _wire_geometry(rows.shape[1], fraction)
        start = torch.as_tensor(draw["start"], dtype=torch.int32,
                                device=delta.device)
        levels = self._quant_levels
        quant_u = None
        if levels is not None:
            quant_u = torch.as_tensor(draw["quant_u"], dtype=torch.float32,
                                      device=delta.device)
        pods = self.num_pods()
        key = "intra_pod" if level == "inner" else "inter_pod"
        vals, mean_vals = be.wire_exchange(
            rows, start, k_blocks=kb, block_rows=BLOCK_ROWS, groups=groups,
            weight=weight, wire_dtype=self.wire_dtype, levels=levels,
            quant_u=quant_u,
            gather=lambda t: self.collective.gather(t, level, pods, key=key))
        if contractive:  # the unscaled window projection: undo nb/kb
            vals = vals * randk_scale(kb, nb)
            mean_vals = mean_vals * randk_scale(kb, nb)
        return (self._scatter_block(delta.shape, start, vals),
                self._scatter_block((groups, *delta.shape[1:]), start,
                                    mean_vals))

    def _scatter_block(self, shape, start, vals):
        be = get_backend(self.backend)
        n_rows = _row_geometry(shape[1:])[0]
        padded = n_rows + (-n_rows) % BLOCK_ROWS
        dense = be.wire_decompress(vals, start, n_rows=padded,
                                   block_rows=BLOCK_ROWS)
        # a padded view's trim is not contiguous; the DIANA kernel wants it so
        return dense[:, :n_rows].reshape(shape).contiguous()

    # independent-seed Rand-k: paper-exact, dense collectives ------------------

    def _exchange_independent(self, delta, level: str, groups: int, draw,
                              fraction: float, contractive: bool = False,
                              weight=None):
        """Unbiased Rand-k over rows, one independent with-replacement draw
        of k row indices per rank (`draw["idx"]`, every rank's), then the
        dense level mean (of the weighted reconstructions when `weight` is
        set). contractive=True keeps the selected rows UNSCALED with set
        semantics (duplicates count once): the projection error feedback
        needs. A process keeps its own ranks' rows of the indices."""
        rows = _row_view(delta.to(torch.float32))
        r, n, d = rows.shape
        k = max(1, int(fraction * n))
        pods = self.num_pods()
        unit = "rank" if level == "inner" else "pod"
        idx = torch.as_tensor(draw["idx"], device=delta.device).to(
            torch.int64)[self.collective.local(unit, pods)]
        flat_idx = (idx + n * torch.arange(r, device=delta.device)[:, None]
                    ).reshape(-1)
        flat = rows.reshape(r * n, d)
        out = torch.zeros_like(flat)
        if contractive:
            out.index_copy_(0, flat_idx, flat[flat_idx])
        else:
            out.index_add_(0, flat_idx, flat[flat_idx] * randk_scale(n, k))
        out = out.reshape(delta.shape)
        shared = self.collective.gather(
            _weighted(out, weight), level, pods,
            key="intra_pod" if level == "inner" else "inter_pod")
        return out, level_mean(shared.reshape(groups, -1, *delta.shape[1:]),
                               dim=1)

    # -- wire accounting ---------------------------------------------------------

    def wire_bytes_per_round(self, params) -> dict[str, int]:
        """Bytes one rank contributes to each wire level per round, from the
        leaves' shapes and dtypes alone ('meta' tensors do): 'intra_pod' the
        inner slab, 'inter_pod' the outer slab, 'dense' an uncompressed mean
        of the same tree. The independent wire moves the dense size."""
        dense = intra = inter = 0
        for leaf in tree_leaves(params):
            rows, cols = _row_geometry(tuple(leaf.shape))
            padded = rows + (-rows) % BLOCK_ROWS
            dense += rows * cols * leaf.dtype.itemsize
            if self.method == "dense" or self.wire == "independent":
                continue
            item = payload_itemsize(self.wire_dtype, self.rule, leaf.dtype)

            def slab_bytes(fraction):
                _, kb = _wire_geometry(padded, fraction)
                slab_rows = kb * BLOCK_ROWS
                return int(slab_rows * cols * item) + scale_sideband_bytes(
                    self.wire_dtype, slab_rows)

            if self.client_axes:
                intra += slab_bytes(self.fraction)
            if self.pod_axes and self.pod_size > 1:
                inter += slab_bytes(self._pod_fraction)
        if self.method != "dense" and self.wire == "independent":
            intra = dense if self.client_axes else 0
            inter = dense if (self.pod_axes and self.pod_size > 1) else 0
        return {"dense": dense, "intra_pod": intra, "inter_pod": inter}


def _row_geometry(shape) -> tuple[int, int]:
    """(rows, cols) of a leaf's row view (`_row_view`) from its shape."""
    if len(shape) >= 2:
        return math.prod(shape[:-1]), shape[-1]
    return math.prod(shape), 1


def _shard_views(x: torch.Tensor, axis, n: int, lead: int = 1) -> list:
    """x's n model shards along `axis` (param coordinates, past `lead`
    leading dims): views, each contiguous only where the axis is the first
    of its dims; [x] for a leaf that is not split."""
    if axis is None:
        return [x]
    size = x.shape[lead + axis] // n
    return [x.narrow(lead + axis, b * size, size) for b in range(n)]


def _join(parts: list, axis) -> torch.Tensor:
    """The shards of a direction (groups, *shard) put together along the
    split axis (one part: itself)."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts, dim=1 + axis)


def _wire_geometry(n_rows_padded: int, fraction: float) -> tuple[int, int]:
    """(nb, kb): row blocks of the padded view and blocks in the window."""
    nb = n_rows_padded // BLOCK_ROWS
    return nb, max(1, int(fraction * nb))


def _in_place(table: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """The table, holding `new`: the per-slot rules write their row into
    the table already; the whole-table rules' new table is copied in."""
    if new is not table:
        table.copy_(new)
    return table


def _weighted(x: torch.Tensor, weight) -> torch.Tensor:
    """x (R, ...) times the (R,) weights on its leading dim (f32, as the
    reference's `g * weight` promotes), or x itself without weights."""
    if weight is None:
        return x
    return x * weight.reshape(-1, *(1,) * (x.dim() - 1))


def _slot_index(slot, groups: int, ranks: int, mean_lead: bool, device):
    """The per-slot tables' row index of a round: (rank-table index, mean-
    table index). A scalar slot (None: row 0) is shared by every group; a
    (groups,) vector gives group p's ranks and mean row its own slot."""
    # analysis: allow[trace-hazard] the slots are the host's numpy vector: no
    # device value is read
    slots = [0] if slot is None else np.asarray(slot).reshape(-1).tolist()
    if len(set(slots)) == 1:
        idx = (slice(None), int(slots[0]))
        return idx, (idx if mean_lead else idx[1:])
    if len(slots) != groups or not mean_lead:
        raise ValueError(f"per-group slots need one slot per group: got "
                         f"{len(slots)} for {groups} groups")
    per_group = torch.as_tensor(slots, dtype=torch.int64, device=device)
    rank_slots = per_group.repeat_interleave(ranks // groups)
    return ((torch.arange(ranks, device=device), rank_slots),
            (torch.arange(groups, device=device), per_group))
