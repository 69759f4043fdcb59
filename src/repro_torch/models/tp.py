"""Tensor parallelism over the mesh's "model" axis: the layers compute on
their model shards, as the reference's GSPMD partitions them
(`repro.launch.sharding`'s Megatron-style specs, `repro.launch.steps`'s
compiler-managed tensor parallelism).

A client's T model shards each hold a slice of every split leaf: the
column-parallel projections (and their biases) on their last axis, the
row-parallel ones on axis -2, the vocab tables on axis 0
(`launch.sharding.leaf_axis`). A process holds some of those shards (all
T on one process, or T / W of them where W processes share the client);
`ModelShards` says which, and `ModelShards.split` turns each split leaf
of a parameter tree into a `Sharded` leaf: the process's shards, in
shard order, stacked on a leading dim (a view of the leaf). The layers
compute on all of a process's shards at once, side by side on that dim:
one batched matmul a projection, one launch an elementwise op.

The conjugate operators (Megatron's f and g), each an autograd Function:

``to_shards``
    identity forward, x for each shard the process holds (a view); the
    backward sums the shards' partial input gradients in shard order;
``from_shards``
    the shards' partial outputs summed in shard order forward; identity
    backward;
``gather_split``
    a split leaf put together whole forward (a view for each shard held);
    the backward sums the shards' gradients of it in shard order and keeps
    this process's slices (where a shard's columns do not align with whole
    heads);
``gathered``
    a split leaf put together whole once, for a computation every shard
    repeats on the same activations (its gradient is then the same on
    every shard): the backward keeps this process's slices of it.

and, on the sequence axis (the reference's `seq_shard`: a block's input
constrained to `P(None, "model", None)`), a pair that splits the rows of
an activation every shard holds whole into ceil(S / T) a shard (the last
shard fewer, as GSPMD pads), moving values and never changing them:

``seq_part``
    the process's shards' rows of the sequence forward; the backward puts
    the rows' gradients together whole from the model group;
``seq_whole``
    the sequence put together whole from the model group forward; the
    backward keeps the process's shards' rows of the gradient (the same
    on every shard, as `to_shards` sums in shard order).

`models.transformer` keeps only `seq_part` of each block's input for the
backward and puts it whole again with `seq_whole` before it recomputes
the block.

Every reduction over the model axis is a sum of the T shards' partials in
shard order 0..T-1, accumulated in f32 and rounded once to the partials'
dtype: the partials of the other processes of the model group are gathered
(`launch.distributed`, level "model", counted under "model") and added
with the shards this process holds, in order. A process holding all T
shards computes every shard's part (a shard's slice of a batched matmul
has the bits of its own product: tests/test_torch_distributed.py holds
that on the host, chip_smoke.py's phase 13 on the card) and adds them the
same way, so any spread of the same mesh gives that run's bits, on any
backend.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.api import tree_flatten

_F32 = torch.float32


def attention_case(num_heads: int, num_kv_heads: int, t: int) -> str:
    """How attention splits over T model shards: "a" where the q and kv
    heads both divide by T (shard j takes q heads [jH/T, (j+1)H/T) and kv
    heads [jKH/T, (j+1)KH/T), exactly the kv heads its q heads read); "b"
    where only the q heads do (each shard puts wk and wv together and
    computes the kv heads its q heads need); "c" where the q heads do not
    (each shard puts every projection together, computes every head and
    hands wo its row shard of the output)."""
    if num_heads % t:
        return "c"
    return "a" if num_kv_heads % t == 0 else "b"


class Sharded:
    """A split leaf as the process holds it: `data`, its shards stacked on
    a new leading dim in shard order (a view of the leaf: contiguous
    blocks of `axis`, a negative axis of each shard, so a stacked layer
    leaf and its layers' slices share it)."""

    __slots__ = ("data", "axis")

    def __init__(self, data: torch.Tensor, axis: int):
        self.data = data
        self.axis = axis

    def unbind(self) -> tuple["Sharded", ...]:
        """Each layer's slice of a stacked leaf."""
        return tuple(Sharded(d, self.axis) for d in self.data.unbind(1))


@dataclasses.dataclass(frozen=True, eq=False)
class ModelShards:
    """Which of a client's `size` (T) model shards this process computes:
    `count` of them from `start` (all T by default); `axes` is each
    parameter leaf's split axis in `tree_flatten` order (None: whole),
    `comm` the collective whose "model" level joins the processes that
    share the client (None, or one process a client: no exchange), `pods`
    the mesh's pods (the collective's group key). Serving adds
    `cache_axes`: each cache leaf's split axis, on the leaf with its layer
    axis, in `tree_flatten` order (None: whole;
    `launch.sharding.cache_axes`), `cache_joint`: which of them split
    over the client ranks and the model shards jointly (a batch the
    clients cannot share), and `joint`: the `Parts` of such a leaf the
    process holds."""

    size: int
    axes: tuple = ()
    start: int = 0
    count: int | None = None
    comm: Any = None
    pods: int = 1
    cache_axes: tuple = ()
    cache_joint: tuple = ()
    joint: Any = None

    def __post_init__(self):
        if self.count is None:
            object.__setattr__(self, "count", self.size)
        if not (0 <= self.start and self.start + self.count <= self.size
                and self.count >= 1):
            raise ValueError(f"shards [{self.start}, {self.start + self.count})"
                             f" of {self.size}")

    @property
    def shards(self) -> range:
        return range(self.start, self.start + self.count)

    @property
    def spread(self) -> bool:
        """Whether other processes hold some of the client's shards."""
        return self.count < self.size

    def gather(self, parts: torch.Tensor) -> torch.Tensor:
        """(count, *shape), this process's shards' rows -> (T, *shape),
        every shard's, in shard order."""
        if not self.spread:
            return parts
        out = self.comm.gather(parts.contiguous(), "model", self.pods,
                               key="model")
        if out.shape[0] != self.size:
            raise ValueError(f"the model group gathered {out.shape[0]} "
                             f"shards, the mesh has {self.size}")
        return out

    def sum(self, parts: torch.Tensor) -> torch.Tensor:
        """The T shards' partials summed in shard order, accumulated in f32
        and rounded once to the partials' dtype; `parts` (count, ...)
        holds this process's shards'."""
        return _sum_in_order(self.gather(parts))

    # a cache leaf split over "model" alone has the shards as its parts
    # (`Parts`' interface: the shards held, gathered over "model")
    level = "model"

    def take(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This process's shards of a whole x split on `dim` (a view)."""
        return _take(x, dim, self.size, self.shards)

    def seq_rows(self, s: int) -> tuple[int, int]:
        """[lo, hi): the rows of a sequence of `s` this process's shards
        hold, ceil(s / T) a shard (`seq_rows`)."""
        return seq_rows(s, self.size, self.shards)

    def cache_parts(self, i: int):
        """The parts of cache leaf i the process holds: its joint parts
        (`joint`), its model shards (the shards themselves), or the whole
        leaf as one part."""
        if self.cache_axes[i] is None:
            return WHOLE
        return self.joint if self.cache_joint[i] else self

    def split(self, params):
        """The parameter tree with each split leaf a `Sharded` of the
        process's shards of it (the leaf holds those shards, in order)."""
        leaves, unflatten = tree_flatten(params)
        if len(leaves) != len(self.axes):
            raise ValueError(f"{len(leaves)} parameter leaves, split axes "
                             f"for {len(self.axes)}")
        out = []
        for x, ax in zip(leaves, self.axes):
            if ax is None:
                out.append(x)
                continue
            if x.shape[ax] % self.count:
                raise ValueError(f"a leaf of shape {tuple(x.shape)} does not "
                                 f"hold {self.count} shards on axis {ax}")
            data = torch.movedim(
                x.unflatten(ax, (self.count, x.shape[ax] // self.count)),
                ax, 0)
            out.append(Sharded(data, ax - x.dim()))
        return unflatten(out)


def _sum_in_order(every: torch.Tensor) -> torch.Tensor:
    """every[0] + every[1] + ... in order, accumulated in f32 and rounded
    once to the partials' dtype. (A bf16 add computes in f32 and rounds
    once, so two partials take one add, with no casts.)"""
    acc = every[0]
    for x in every[1:-1]:
        acc = acc.to(_F32) + x
    if len(every) > 1:
        acc = (acc + every[-1]).to(every[-1].dtype)
    return acc


@dataclasses.dataclass(frozen=True, eq=False)
class Parts:
    """A serving cache leaf split into `size` parts on one axis, as a
    process holds it: `shards`, the parts it holds, in part order,
    exchanged over `level` of `comm` (no exchange where it holds every
    part: `comm` and `level` None). A leaf split over the client ranks
    and the model shards jointly has C x T parts, client rank c's shard
    j part c * T + j (level "joint", `order` the parts a gather stacks,
    in its order); a whole leaf is one part. (A leaf split over "model"
    alone has the `ModelShards` themselves as its parts.)"""

    size: int
    shards: tuple
    comm: Any = None
    pods: int = 1
    level: str | None = None
    order: tuple = ()

    @property
    def count(self) -> int:
        return len(self.shards)

    @property
    def spread(self) -> bool:
        return self.count < self.size

    def gather(self, parts: torch.Tensor) -> torch.Tensor:
        """(count, *shape), the held parts' rows -> (size, *shape), every
        part's, in part order."""
        if not self.spread:
            return parts
        out = self.comm.gather(parts.contiguous(), self.level, self.pods,
                               key=self.level)
        if out.shape[0] != self.size:
            raise ValueError(f"the {self.level} group gathered "
                             f"{out.shape[0]} parts, the leaf has "
                             f"{self.size}")
        if self.order and list(self.order) != sorted(self.order):
            out = out[torch.argsort(torch.tensor(self.order))]
        return out

    def sum(self, parts: torch.Tensor) -> torch.Tensor:
        """The parts' partials summed in part order, accumulated in f32 and
        rounded once to their dtype (`ModelShards.sum`)."""
        return _sum_in_order(self.gather(parts))

    def take(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The held parts of a whole x split on `dim`, in part order (a
        view where they are contiguous)."""
        return _take(x, dim, self.size, self.shards)


def _take(x: torch.Tensor, dim: int, size: int, held) -> torch.Tensor:
    n = x.shape[dim] // size
    lo = held[0]
    if list(held) == list(range(lo, lo + len(held))):
        return x.narrow(dim, lo * n, len(held) * n)
    return torch.cat([x.narrow(dim, p * n, n) for p in held], dim)


WHOLE = Parts(1, (0,))  # a leaf no axis of which splits: one part, held


def seq_rows(s: int, t: int, shards: range) -> tuple[int, int]:
    """[lo, hi): the rows of a sequence of `s` that `shards` of T hold,
    ceil(s / T) a shard and the last shards fewer (or none), as GSPMD
    pads a dimension T does not divide."""
    n = -(-s // t)
    return min(shards.start * n, s), min(shards.stop * n, s)


def _seq_part(x: torch.Tensor, ms: ModelShards | None,
              dim: int) -> torch.Tensor:
    if ms is None or not ms.spread:
        return x
    lo, hi = ms.seq_rows(x.shape[dim])
    return x.narrow(dim, lo, hi - lo)


def _seq_whole(part: torch.Tensor, ms: ModelShards | None, s: int,
               dim: int) -> torch.Tensor:
    """The rows of every shard put together in shard order: each process's
    rows padded to ceil(s / T) a shard, gathered over the model group
    (counted under "model"), the padding cut."""
    if ms is None or not ms.spread:
        return part
    n = -(-s // ms.size)
    pad = ms.count * n - part.shape[dim]
    if pad:
        shape = list(part.shape)
        shape[dim] = pad
        part = torch.cat([part, part.new_zeros(shape)], dim)
    every = ms.gather(torch.movedim(part.unflatten(dim, (ms.count, n)),
                                    dim, 0))
    return torch.movedim(every, 0, dim).flatten(dim, dim + 1).narrow(
        dim, 0, s)


# -- the conjugate operators ----------------------------------------------------
#
# Each takes and gives the process's shards stacked on a leading dim of
# `count` (`ModelShards.count`): a layer computes on all of them at once
# (one batched matmul, one elementwise launch), shard i's slice of it the
# arithmetic a process holding shard i alone does.

class _ToShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ms):
        ctx.ms = ms
        return x.unsqueeze(0).expand(ms.count, *x.shape)

    @staticmethod
    def backward(ctx, g):
        return ctx.ms.sum(g), None


class _FromShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ms, parts):
        ctx.count = ms.count
        return ms.sum(parts)

    @staticmethod
    def backward(ctx, g):
        return None, g.unsqueeze(0).expand(ctx.count, *g.shape)


def _whole(ms, axis, data) -> torch.Tensor:
    every = ms.gather(data)
    return torch.cat(list(every.unbind(0)), dim=axis)


def _own(ms, axis, total) -> torch.Tensor:
    """This process's shards of a whole leaf's gradient, stacked."""
    size = total.shape[axis] // ms.size
    every = torch.movedim(total.unflatten(axis, (ms.size, size)), axis - 1, 0)
    return every[ms.start:ms.start + ms.count]


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ms, axis, data):
        ctx.ms, ctx.axis = ms, axis
        whole = _whole(ms, axis, data)
        return whole.unsqueeze(0).expand(ms.count, *whole.shape)

    @staticmethod
    def backward(ctx, g):
        return None, None, _own(ctx.ms, ctx.axis, ctx.ms.sum(g))


class _Gathered(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ms, axis, data):
        ctx.ms, ctx.axis = ms, axis
        return _whole(ms, axis, data)

    @staticmethod
    def backward(ctx, g):
        return None, None, _own(ctx.ms, ctx.axis, g)


class _SeqPart(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ms, dim):
        ctx.ms, ctx.dim, ctx.s = ms, dim, x.shape[dim]
        return _seq_part(x, ms, dim)

    @staticmethod
    def backward(ctx, g):
        return _seq_whole(g, ctx.ms, ctx.s, ctx.dim), None, None


class _SeqWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, ms, s, dim):
        ctx.ms, ctx.dim = ms, dim
        return _seq_whole(part, ms, s, dim)

    @staticmethod
    def backward(ctx, g):
        return _seq_part(g, ctx.ms, ctx.dim), None, None, None


def seq_part(x: torch.Tensor, ms: ModelShards | None,
             dim: int = 1) -> torch.Tensor:
    """The process's shards' rows of x's sequence axis `dim` (a view; x
    itself where the process holds every shard)."""
    return _SeqPart.apply(x, ms, dim)


def seq_whole(part: torch.Tensor, ms: ModelShards | None, s: int,
              dim: int = 1) -> torch.Tensor:
    """A sequence of `s` rows whole again from each shard's rows
    (`seq_part`'s), gathered over the model group."""
    return _SeqWhole.apply(part, ms, s, dim)


def put_together(parts: torch.Tensor, ms: ModelShards,
                 dim: int) -> torch.Tensor:
    """The shards' slices of an activation, (count, ...) this process's,
    put together whole along `dim` (of a slice): every shard's gathered
    over the model group and concatenated in shard order."""
    return _whole(ms, dim, parts)


def to_shards(x: torch.Tensor, ms: ModelShards) -> torch.Tensor:
    """x for each shard the process holds, (count, *x.shape), a view
    (Megatron's f)."""
    return _ToShards.apply(x, ms)


def from_shards(parts, ms: ModelShards) -> torch.Tensor:
    """The shards' partials (count, ...), or a sequence of them, summed
    over the model axis (Megatron's g)."""
    if not torch.is_tensor(parts):
        parts = torch.stack(tuple(parts))
    return _FromShards.apply(ms, parts)


def gather_split(leaf: Sharded, ms: ModelShards) -> torch.Tensor:
    """A split leaf whole, for each shard the process holds (count, ...)."""
    return _GatherSplit.apply(ms, leaf.axis, leaf.data)


def gathered(leaf, ms: ModelShards):
    """A leaf whole, once, for a replicated computation: `_Gathered` of a
    split leaf, the leaf itself if whole (None stays None)."""
    if isinstance(leaf, Sharded):
        return _Gathered.apply(ms, leaf.axis, leaf.data)
    return leaf


def parts(leaf, axis: int, name: str) -> torch.Tensor:
    """The process's shards of a leaf the layer splits on `axis`
    (negative), stacked (count, ...); raises, naming the leaf, where the
    model axis's spec left it whole or split it elsewhere."""
    if not isinstance(leaf, Sharded) or leaf.axis != axis:
        got = ("whole" if not isinstance(leaf, Sharded)
               else f"split on axis {leaf.axis}")
        raise ValueError(f"{name}: the compute-sharded layer splits it on "
                         f"axis {axis}, the model axis's spec leaves it "
                         f"{got}")
    return leaf.data


def whole(leaf, ms: ModelShards) -> torch.Tensor:
    """A leaf whole for each shard the process holds (count, ...), its
    gradient summed over the shards: `gather_split` of a split leaf,
    `to_shards` of a whole one."""
    if isinstance(leaf, Sharded):
        return gather_split(leaf, ms)
    return to_shards(leaf, ms)


def replicated(leaf, name: str) -> torch.Tensor:
    """A leaf the layer computes with whole on every shard (a norm, the
    router, a row-parallel bias); raises, naming it, if the spec split
    it."""
    if isinstance(leaf, Sharded):
        raise ValueError(f"{name}: the compute-sharded layer reads it whole, "
                         f"the model axis's spec splits it on axis "
                         f"{leaf.axis}")
    return leaf
