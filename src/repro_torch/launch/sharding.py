"""What each leaf of the train state is split over (port of the
reference's `launch/sharding.py`): its client rows and its model shards.

The model axis (`_COL`:27, `_ROW`:32, `_VOCAB`:33, `_REPLICATED`:34,
`_leaf_spec`:54, `param_specs`:79 and the model part of `shifts_specs`:91,
`podded_specs`:109 and `slotted_specs`:124). The reference gives each leaf
a PartitionSpec; here the result is plain data: for each leaf, keyed by
its path (`core.api.tree_paths`), the axis split over the mesh's T model
shards, or None where the leaf is replicated. The rules, by the leaf's
name (its last dict key):

- vocab-parallel (`embed`, `lm_head`): axis 0;
- column-parallel projections and their biases: the last axis;
- row-parallel projections and the per-head (H, hd) tensors: axis -2,
  falling back to the last axis where H does not divide by T (hymba's 25
  heads);
- every other leaf, and any leaf whose candidate axes do not divide by T:
  replicated.

The stacked-layer axis of a block's leaves is never split. The wire
compresses each shard of a split leaf on its own (`core.dist`).

The client rows (the client-rank part of `shifts_specs`, `podded_specs`,
`slotted_specs` and `batch_specs`:134). Spread over processes
(`launch.distributed`) a leaf is

- per rank ("rank"): its leading rows are the client ranks, and a process
  holds its own (the DIANA shifts; the batch);
- per pod ("pod"): its leading rows are the pods, and a process holds the
  pods it serves (the two-level wire's pod tables, the per-pod mean
  shifts);
- whole (None): the parameters, the optimizer state, the step, the flat
  mean shift and the global pod mean shift;

and of a split leaf a process holds its model shards only (where the
model axis spreads over processes). `CompressedAggregation.table_units`
and `model_axes` are the rules; `init_train_state` lays the state out by
them and `StateShards` gathers and splits a checkpoint by them.

The layers over the model axis. The reference's GSPMD partitions every
layer's compute by these specs; the port's layers of every family
compute on their model shards the same way (`models.tp`, `model_shards`;
`attention_case` is the attention's split at T, `model_bytes` what a
step sends the model group), and no step gathers the weights whole.

`zero1_specs`:178 (the optimizer state split over the clients) and
`cache_specs`:138 (the serving cache over the mesh) lay out storage that
the port does not split yet (ROADMAP Queue A).
"""
from __future__ import annotations

import torch

from repro_torch.core.api import tree_flatten, tree_leaves, tree_paths
from repro_torch.models import mixers, tp

# last-axis column-parallel weights (and their biases)
_COL = {
    "wq", "wk", "wv", "wx", "wbc", "wdt", "wr", "wg", "w_up", "w_gate", "wA",
    "bq", "bk", "bv", "b_up", "w0", "mu",
}
# axis -2 row-parallel weights / per-head (H, hd) tensors
_ROW = {"wo", "w_down", "wo_fused", "wB", "u", "ln", "ln_attn", "ln_out"}
_VOCAB = {"embed", "lm_head"}
_REPLICATED = {"router", "scale", "bias", "a_log", "pos_embed"}

_LEVEL = {"rank": "world", "pod": "outer"}  # the gather that makes a table


def _model_size(mesh) -> int:
    return int(mesh.shape["model"]) if mesh is not None else 16


def leaf_names(tree) -> list[str]:
    """Each leaf's name, in `tree_flatten`'s order: its last dict key (a
    NamedTuple field counts as one; list indices do not), as the
    reference's `_path_names` reads a key path."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [n or str(k) for k in sorted(tree)
                for n in leaf_names(tree[k])]
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return [n or f for f, v in zip(tree._fields, tree)
                for n in leaf_names(v)]
    if isinstance(tree, (list, tuple)):
        return [n for t in tree for n in leaf_names(t)]
    return [""]


def leaf_axis(name: str, shape, msize: int) -> int | None:
    """The axis of a leaf named `name` of `shape` that the model axis of
    `msize` shards splits, or None (`_leaf_spec`:54)."""
    nd = len(shape)

    def try_axes(*axes):
        for ax in axes:
            if 0 <= ax < nd and shape[ax] % msize == 0 and shape[ax] > 0:
                return ax
        return None

    if name in _VOCAB:
        return try_axes(0)
    if name in _REPLICATED:
        return None
    if name in _COL and nd >= 1:
        return try_axes(nd - 1)
    if name in _ROW and nd >= 2:
        return try_axes(nd - 2, nd - 1)
    return None


def split_axes(params, msize: int) -> tuple[int | None, ...]:
    """Each parameter leaf's split axis, in `tree_flatten`'s order (what
    `CompressedAggregation.model_axes` holds)."""
    return tuple(leaf_axis(n, tuple(p.shape), msize)
                 for n, p in zip(leaf_names(params), tree_leaves(params)))


def _specs(params, lead: int, msize: int) -> dict[str, int | None]:
    return {p: None if ax is None else ax + lead
            for p, ax in zip(tree_paths(params), split_axes(params, msize))}


def param_specs(params, *, mesh=None) -> dict[str, int | None]:
    """{leaf path: the axis split over "model", or None} (`param_specs`:79;
    a mesh of None means the production mesh's 16 shards)."""
    return _specs(params, 0, _model_size(mesh))


def shifts_specs(params, *, mesh=None, n_slots: int = 0) -> dict:
    """The per-client shift tables (M, [n_slots,] *param): each leaf's
    split axis, past the client axis and the slot axis (present whenever
    n_slots >= 1) (`shifts_specs`:91)."""
    return _specs(params, 1 + bool(n_slots), _model_size(mesh))


def podded_specs(params, *, mesh=None, n_slots: int = 0) -> dict:
    """Per-pod state (P, [n_slots,] *param) (`podded_specs`:109)."""
    return _specs(params, 1 + bool(n_slots), _model_size(mesh))


def slotted_specs(params, *, mesh=None, n_slots: int = 0) -> dict:
    """Param-aligned tables with a leading slot axis ([n_slots,] *param)
    (`slotted_specs`:124); n_slots=0 gives the plain param specs."""
    return _specs(params, bool(n_slots), _model_size(mesh))


# -- the layers over the model axis -------------------------------------------

def attention_case(cfg, t: int) -> str:
    """The attention's split over T model shards (`tp.attention_case`):
    "a" aligned q and kv heads, "b" the kv heads put together, "c" every
    head on every shard (hymba's mixer at every T, `hymba_train_tp`)."""
    if cfg.attention_mixer == "hymba" and t > 1:
        return "c"
    return tp.attention_case(cfg.num_heads, cfg.num_kv_heads, t)


def model_layout(cfg, t: int) -> str:
    """What the trainer prints of the model axis: how the layers meet
    the T shards."""
    if t == 1:
        return "model axis: 1 shard (whole layers)"
    mixer = ("time-mix heads by shard, case"
             if cfg.attention_mixer == "rwkv6" else "attention case")
    return (f"model axis: {t} shards, layers compute by shard, as every "
            f"family's do (the {cfg.family} family; {mixer} "
            f"{attention_case(cfg, t)})")


def model_shards(agg, cfg) -> tp.ModelShards | None:
    """The model shards the process's layers compute on: its shards of
    each split leaf (`agg.model_axes`, from `leaf_axis`) cut by
    `ModelShards.split`, or None where T = 1 (the whole layers). `agg` is
    bound to the mesh and the parameters (`steps.configure_agg`)."""
    t = agg.model_size
    if t == 1:
        return None
    shards = agg.local_shards
    return tp.ModelShards(t, axes=tuple(agg.model_axes), start=shards.start,
                          count=shards.stop - shards.start,
                          comm=agg.collective, pods=agg.num_pods())


def _gathered_bytes(layer, t: int, names) -> int:
    """What one shard sends to put the leaves `names` of a layer's
    parameters (one layer's shapes, on the meta device) together: its
    part of each leaf the spec splits at T (`tp.gathered`)."""
    return sum(x.numel() * x.element_size() // t
               for n, x in layer.items()
               if n in names and leaf_axis(n, tuple(x.shape), t) is not None)


def _attention_bytes(cfg, t: int, n: int, e: int, src: int = 0) -> int:
    """One shard's bytes to its model group in one attention layer
    (`mixers._attention_tp`) over n query tokens, of the stream itself or
    (src > 0) of `src` tokens of the encoder's output (cross-attention),
    forward, backward and the recomputed
    forward: wo's partials (n x d_model) twice; the input gradients of
    the stream and, for cross-attention, of the key source (case a, b);
    case b's wk and wv (and biases) put together, twice, and their whole
    gradients summed; case c's projections put together, twice, and the
    output's cotangent (n x H x hd) summed."""
    d = cfg.d_model
    case = tp.attention_case(cfg.num_heads, cfg.num_kv_heads, t)
    out = 2 * n * d * e
    if case == "c":
        layer = mixers.init_attention(None, cfg, "meta")
        return (out + 2 * _gathered_bytes(layer, t, ("wq", "wk", "wv", "bq",
                                                      "bk", "bv"))
                + n * cfg.num_heads * cfg.head_dim * e)
    out += (n + src) * d * e
    if case == "b":
        layer = mixers.init_attention(None, cfg, "meta")
        kv = ("wk", "wv", "bk", "bv")
        out += 2 * _gathered_bytes(layer, t, kv) + sum(
            x.numel() * x.element_size() for k, x in layer.items()
            if k in kv)
    return out


def model_bytes(cfg, rows: int, seq: int, t: int, shards: int) -> int:
    """What a process that computes `shards` of a client's T model shards
    sends its model group in one forward and backward of `rows` sequences
    of `seq` tokens with remat "full", the layers by shard (`models.tp`;
    the recomputed forward of each block stops at the last activation its
    backward needs, before the FFN's reduction). Activations (tokens x
    d_model in the model's dtype unless named) and, where a layer puts a
    split leaf together, its shards' part of it:

    - every family: the embedding's partials and the CE's three per-token
      f32 scalars (max, sum of exponentials, gold logit) forward, the
      head's input gradient backward; each block's FFN partials forward
      and input gradient backward (a MoE block's routing weights' too,
      tokens x k f32);
    - an attention block (`_attention_bytes`): dense, moe, vlm, whisper's
      decoder self-attention and its encoder's blocks over the frames;
    - whisper's decoder cross-attention: its partials forward and
      recomputed, the stream's input gradient and the encoder output's
      (frames x d_model) summed cotangent;
    - rwkv6's time mix: `mu` put together and the f32 decay pre-activation
      (tokens x d_model x 4 B) summed, each forward and recomputed, and
      the pre-activation's cotangent summed backward; wo's partials
      forward and recomputed, the five mixes' input gradients;
    - hymba's mixer (case c at every T): its split projections and norms
      put together, forward and recomputed, wo_fused's partials forward
      and recomputed, the fused output's cotangent (tokens x H x hd)
      summed."""
    e = torch.finfo(cfg.dtype).bits // 8
    tok, d = rows * seq, cfg.d_model
    act = tok * d * e
    ffn = 2 * act + tok * cfg.experts_per_token * 4
    if cfg.attention_mixer == "rwkv6":
        layer = mixers.init_rwkv6(None, cfg, "meta")
        mixer = (2 * _gathered_bytes(layer, t, ("mu",)) + 3 * tok * d * 4
                 + 2 * act + 5 * act)
    elif cfg.attention_mixer == "hymba":
        layer = mixers.init_hymba(None, cfg, "meta")
        names = ("wq", "wk", "wv", "bq", "bk", "bv")
        split = (_gathered_bytes(layer["attn"], t, names)
                 + _gathered_bytes(layer["ssm"], t, tuple(layer["ssm"]))
                 + _gathered_bytes(layer, t, ("ln_attn",)))
        mixer = (2 * split + 2 * act
                 + tok * cfg.num_heads * cfg.head_dim * e)
    else:
        mixer = _attention_bytes(cfg, t, tok, e)
    block = mixer + ffn
    encoder = 0
    if cfg.is_encdec:
        frames = rows * cfg.encoder_seq
        block += _attention_bytes(cfg, t, tok, e, src=frames)
        encoder = cfg.encoder_layers * (
            _attention_bytes(cfg, t, frames, e) + 2 * frames * d * e)
    return shards * (2 * act + 3 * tok * 4 + cfg.num_layers * block
                     + encoder)


# -- a state over processes ---------------------------------------------------

def leaf_units(state, agg) -> list[str | None]:
    """Each leaf's unit ("rank", "pod" or None), in the order of
    `tree_leaves(state)`; `agg` bound to the mesh (`steps.configure_agg`)."""
    tables = agg.table_units()._asdict()
    out = []
    for name, sub in zip(state._fields, state):
        out += [tables.get(name)] * len(tree_leaves(sub))
    return out


def leaf_model_axes(state, agg) -> list[int | None]:
    """Each state leaf's split axis (None: whole), in the order of
    `tree_leaves(state)`. A subtree with the parameters' leaf count is
    laid out like them, each leaf a table (*lead, *param) of its
    parameter; a tuple of other subtrees (the optimizer's) is read member
    by member; any other leaf is whole."""
    axes = agg.model_axes or ()
    nd = [len(p.shape) for p in tree_leaves(state.params)]

    def walk(sub):
        leaves = tree_leaves(sub)
        if not leaves:
            return []
        if len(leaves) == len(nd) and axes:
            return [None if ax is None else x.dim() - n + ax
                    for x, n, ax in zip(leaves, nd, axes)]
        if isinstance(sub, (tuple, list)):
            return [a for s in sub for a in walk(s)]
        return [None] * len(leaves)

    return [a for sub in state for a in walk(sub)]


def take_shards(tree, agg, lead: int = 0):
    """This process's model shards of every split leaf of a param-shaped
    tree (leaves (*lead dims, *param)), copied out; the tree itself where
    the process holds every shard."""
    shards = agg.local_shards
    if shards == slice(0, agg.model_size):
        return tree
    leaves, unflatten = tree_flatten(tree)
    out = []
    for x, ax in zip(leaves, agg.model_axes):
        if ax is not None:
            n = x.shape[lead + ax] // agg.model_size
            x = x.narrow(lead + ax, shards.start * n,
                         (shards.stop - shards.start) * n).clone()
        out.append(x)
    return unflatten(out)


def local_clients(agg) -> slice:
    """The process's client ranks: the rows of the batch it feeds."""
    return agg.collective.local("rank", agg.num_pods())


class StateShards:
    """A train state spread over processes, as `checkpoint.io` writes and
    reads it: the writer (process 0) writes the reference's file with
    every per-rank and per-pod leaf gathered in rank order and every split
    leaf's shards put together, byte for byte the stacked run's file;
    every process takes part in each gather and, reading, keeps its own
    rows and shards of each such leaf."""

    def __init__(self, agg, state_like):
        self.comm = agg.collective
        self.pods = agg.num_pods()
        self.units = leaf_units(state_like, agg)
        self.axes = leaf_model_axes(state_like, agg)
        self.model = agg.model_size
        self.shards = agg.local_shards

    @property
    def writes(self) -> bool:
        return self.comm.rank == 0

    def full_shape(self, i: int, shape: list) -> list:
        unit, ax = self.units[i], self.axes[i]
        shape = list(shape)
        if ax is not None:
            shape[ax] = shape[ax] * self.model // (self.shards.stop
                                                   - self.shards.start)
        if unit is None:
            return shape
        return [self.comm.units(unit, self.pods, shape[0]), *shape[1:]]

    def gather(self, i: int, leaf):
        """Leaf i whole on the writer (None, or a part, elsewhere): the
        model group's shards put together on its first process, then the
        rows of those processes gathered on the writer. Only the writer
        keeps the leaf, so only it receives it (on the host where the
        backend stages its messages there: several processes may share
        one card)."""
        unit, comm = self.units[i], self.comm
        if comm.host_staged:
            leaf = leaf.cpu()
        if self.axes[i] is not None and comm.model_procs > 1:
            parts = comm.gather(leaf.unsqueeze(0), "model", self.pods,
                                to_first=True)
            if parts is None:
                return None
            leaf = torch.cat(list(parts.unbind(0)), dim=self.axes[i])
        if unit is None:
            return leaf
        if comm.rank % comm.model_procs:  # its model group's first speaks
            return None
        return comm.gather(leaf, _LEVEL[unit], self.pods, to_first=True)

    def local(self, i: int, arr):
        unit, ax = self.units[i], self.axes[i]
        if unit is not None:
            arr = arr[self.comm.local(unit, self.pods)]
        if ax is not None and self.shards != slice(0, self.model):
            n = arr.shape[ax] // self.model
            index = [slice(None)] * arr.ndim
            index[ax] = slice(self.shards.start * n, self.shards.stop * n)
            arr = arr[tuple(index)]
        return arr
