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

The serving cache (`cache_specs`:138): each cache leaf (L, B, ...) has
its requests (axis 1) split over the client ranks where B >= clients and
divides, and its widest divisible axis from axis 2 on split over the
model shards; where B < clients or they do not divide it (long_500k's B
= 1) the batch stays whole on every client and that axis is split over
the clients and the model shards jointly where it divides, else over the
model shards alone, else not at all. The serve steps lay the cache out
so (`cache_axes`: the attention caches on their
slots, or on head_dim where the slots are the narrower or do not divide,
rwkv6's state on its heads or key dim, hymba's SSD state on head_dim)
and compute on it by shard (`models.mixers`' `*_decode_tp`); where the
batch stays whole, each process computes the dense work of its model
shards once for all its clients and loops over its joint parts where it
touches the cache (`steps.serve_shards`, `tp.Parts`).
`serve_model_bytes` is what a token sends the model group,
`serve_joint_bytes` what it sends the joint group.

`zero1_specs`:178 splits each leaf's optimizer state over the clients as
well (ZeRO-1). As in the reference, nothing applies it: it is data for
whoever shards the optimizer state.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.api import tree_flatten, tree_leaves, tree_paths
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import mixers, tp, transformer

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


class CacheSpec(NamedTuple):
    """A cache leaf's layout (the reference's PartitionSpec as data):
    `batch`, whether its requests (axis 1) split over the client ranks;
    `axis`, the axis split over "model" (with `joint`, over the client
    ranks and "model" together), or None."""

    batch: bool
    axis: int | None
    joint: bool = False


def _mesh_clients(mesh) -> int:
    return math.prod(int(v) for k, v in mesh.shape.items() if k != "model")


def cache_specs(cache, *, mesh, n_clients: int = 1) -> list[CacheSpec]:
    """Each cache leaf's layout, in `tree_flatten` order (`cache_specs`:138;
    leaves (L, B, ...)): B >= n_clients and divisible, the batch over the
    client axes and the widest divisible axis from axis 2 on over "model";
    else the batch whole and the widest axis over (clients, "model")
    jointly where it divides, else over "model" alone, else whole. Ties
    keep the lower axis."""
    msize = _model_size(mesh)
    joint = _mesh_clients(mesh) * msize
    out = []
    for leaf in tree_leaves(cache):
        shape = tuple(leaf.shape)
        if len(shape) < 2:
            out.append(CacheSpec(False, None))
            continue
        rest = sorted(range(2, len(shape)), key=lambda i: -shape[i])
        if batch_shared(shape[1], n_clients):
            ax = next((i for i in rest if shape[i] % msize == 0), None)
            out.append(CacheSpec(True, ax))
            continue
        spec = CacheSpec(False, None)
        for i in rest:
            if shape[i] % joint == 0:
                spec = CacheSpec(False, i, True)
                break
            if shape[i] % msize == 0:
                spec = CacheSpec(False, i)
                break
        out.append(spec)
    return out


def cache_axes(cfg, cache_len: int, mesh,
               batch: int | None = None) -> tuple[CacheSpec, ...]:
    """Each leaf's `CacheSpec` for a cache of `batch` requests (by default
    one a client rank) and `cache_len` on `mesh`: `cache_specs` of the
    cache's shapes (what `tp.ModelShards.cache_axes` and `cache_joint`
    hold). A batch the client ranks share splits its requests over them;
    any other (fewer requests than clients, or a batch they do not divide)
    stays whole on every client, its leaves split jointly, over "model"
    alone, or not at all."""
    m = _mesh_clients(mesh)
    like = transformer.init_cache(
        transformer.init_params(0, cfg, "meta"), cfg,
        batch=m if batch is None else batch, cache_len=cache_len)
    return tuple(cache_specs(like, mesh=mesh, n_clients=m))


def batch_shared(b: int, clients: int) -> bool:
    """Whether `clients` client ranks share a batch of b requests
    (`cache_specs`' batch split): else every client serves it whole."""
    return b >= clients and b % clients == 0


class Zero1Spec(NamedTuple):
    """A leaf's optimizer-state layout: its `model` axis (`param_specs`)
    and the axis split over the client ranks, or None."""

    model: int | None
    clients: int | None


def zero1_specs(params, *, mesh=None) -> dict[str, Zero1Spec]:
    """{leaf path: Zero1Spec} (`zero1_specs`:178): the leaf's model axis,
    and the client ranks on its first axis that "model" leaves unsplit
    and that divides by them; never a block's stacked-layer axis (a leaf
    under "blocks" of two or more dims). A mesh of None means the
    production mesh (16 clients of 16 shards). Nothing applies it."""
    msize = _model_size(mesh)
    csize = _mesh_clients(mesh) if mesh is not None else 16
    out = {}
    for path, x, ax in zip(tree_paths(params), tree_leaves(params),
                           split_axes(params, msize)):
        shape = tuple(x.shape)
        start = 1 if "blocks" in path.split("/") and len(shape) >= 2 else 0
        clients = next((i for i in range(start, len(shape))
                        if i != ax and shape[i] > 0
                        and shape[i] % csize == 0), None)
        out[path] = Zero1Spec(ax, clients)
    return out


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


# analysis: allow[ignored-argument] callers name the config the shards are of;
# the bound agg holds everything the shards need
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

    - with the train step's `seq_shard` (its default), each decoder
      block's and the final norm's stash put whole again before its
      recompute: each shard's ceil(seq / T) rows of it (the last shard's
      padded), rows x d_model each;

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
    stash = (cfg.num_layers + 1) * rows * -(-seq // t) * d * e
    return shards * (2 * act + 3 * tok * 4 + cfg.num_layers * block
                     + encoder + stash)


def fleet_bytes(row_bytes: int, cohort, lay, *, done=None) -> int:
    """What the process of `lay` (a `launch.distributed.RankLayout`)
    sends at the "fleet" level in one round of a fleet spread over
    processes (`fleet.store.FleetPlacement`), given the round's sorted
    `cohort` of the mesh's client ranks: for the gather before the step,
    the rows of the clients it owns (client c: the process at position
    c mod P among the P of its model index) that another process serves
    (client rank i: the process whose ranks hold i); for the scatter
    after it, the rows it serves of the clients another owns, of those
    that complete the round (`done`, an (m,) bool mask; all by default).
    `row_bytes` is one client's row on the process: its shards' slices of
    every shift leaf (`ClientStateStore.row_nbytes`). A round nobody
    completes moves nothing (the async driver skips it)."""
    cohort = [int(c) for c in cohort]
    done = [True] * len(cohort) if done is None else [bool(d) for d in done]
    if not any(done):
        return 0
    procs = lay.client_world
    me = lay.rank // lay.model_procs
    owner = [c % procs for c in cohort]
    server = [i // lay.local for i in range(len(cohort))]
    rows = sum(1 for i in range(len(cohort))
               if owner[i] == me and server[i] != me)
    rows += sum(1 for i in range(len(cohort))
                if done[i] and server[i] == me and owner[i] != me)
    return rows * row_bytes


def _split(layer, name: str, t: int) -> bool:
    x = layer.get(name)
    return x is not None and leaf_axis(name, tuple(x.shape), t) is not None


def _cols_bytes(layer, names, t: int, n: int, e: int) -> int:
    """One shard's column chunks of the projections `names` over n tokens
    (`layers.cols_whole`)."""
    return sum(n * layer[w].shape[-1] // t * e for w in names
               if _split(layer, w, t))


def _attend_bytes(cfg, t: int, n: int, e: int, axis: int, cap: int) -> int:
    """One shard's part of `mixers.attend_by_shard` for n rows: the slots'
    partial statistics (f32 max, sum and product), or head_dim's partial
    scores over `cap` slots and its slice of the output."""
    h, hd = cfg.num_heads, cfg.head_dim
    if axis == 1:
        return n * h * (hd + 2) * 4
    return n * h * cap * 4 + n * h * hd // t * e


def _prefill_attention_bytes(cfg, t: int, n: int, e: int) -> int:
    """`_attention_bytes`' forward alone: wo's partials, case b's wk and
    wv (and biases) put together, case c's projections put together."""
    layer = mixers.init_attention(None, cfg, "meta")
    case = tp.attention_case(cfg.num_heads, cfg.num_kv_heads, t)
    out = n * cfg.d_model * e
    if case == "b":
        out += _gathered_bytes(layer, t, ("wk", "wv", "bk", "bv"))
    elif case == "c":
        out += _gathered_bytes(layer, t, ("wq", "wk", "wv", "bq", "bk",
                                          "bv"))
    return out


def _levels(cfg, rows: int, cache_len: int, t: int, mesh):
    """Each cache leaf's (axis of a request row's leaf, the group its
    parts exchange over: "model", "joint" or None for a whole leaf) for
    `rows` requests on `mesh` (None: one client of T shards, the batch
    split), and the number of joint parts."""
    if mesh is None:
        mesh = make_mesh((1, t))
    layout = cache_axes(cfg, cache_len, mesh,
                        None if batch_shared(rows, _mesh_clients(mesh))
                        else rows)
    return ([(None if sp.axis is None else sp.axis - 1,
              "joint" if sp.joint else "model" if sp.axis is not None
              else None) for sp in layout], _mesh_clients(mesh) * t)


def serve_model_bytes(cfg, rows: int, cache_len: int, t: int, shards: int,
                      *, prompt: int = 0, mesh=None) -> int:
    """What a process that computes `shards` of a client's T model shards
    sends its model group to decode one token of `rows` requests from a
    cache of `cache_len` laid out by `cache_axes` (or, with `prompt`, to
    prefill `prompt` tokens of them): activations in the model's dtype
    unless named, each gathered once a shard (`models.tp`). `rows` are a
    client's where the client ranks share the batch; with `mesh`, a batch
    they do not share is the whole batch, which the process computes once
    for all its clients, its cache laid out jointly (what its parts send
    the joint group is `serve_joint_bytes`). No cache byte after prefill.
    A token:

    - the embedding's partials (rows x d_model), each block's FFN
      partials and its mixer's output projection's partials, the
      vocab-parallel head's logits (rows x Vp / T);
    - attention (self, hymba's, whisper's cross): q, k and v's column
      chunks (cross: q's), and, for a cache split over "model" alone,
      `attend_by_shard`'s part (the slots' f32 statistics rows x H x (hd
      + 2), or head_dim's f32 scores rows x H x slots and its slice of
      the output);
    - rwkv6: the five token-shift mixes' d_model slices, the decay
      LoRA's f32 partials (rows x d_model x 4 B) and, with the state not
      split over "model" on its heads, r, k, v and the decay's slices in
      f32, and with it split over "model" on its key dim the f32 partial
      reads (rows x d_model x 4 B);
    - hymba: the SSD streams' column chunks (wx, wbc, wdt where split),
      the SSD output's head_dim slices where the state splits over
      "model", and the fused heads' norm slices.

    The prefill: the forward by shard (`model_bytes`' forward terms: the
    embedding, each block's FFN and mixer partials, case b's and c's
    weights, rwkv6's `mu` and f32 decay, hymba's split leaves, whisper's
    encoder) plus the cache's k and v chunks of every attention layer
    (whisper's cross cache over the frames), rwkv6's states where its
    state does not split over "model" on its heads, and the last token's
    logits."""
    e = torch.finfo(cfg.dtype).bits // 8
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    n = rows * max(prompt, 1)
    leaves, _ = _levels(cfg, rows, cache_len, t, mesh)
    whole = mixers.init_attention(None, cfg, "meta")
    vp = cfg.padded_vocab()
    # the vocab-parallel embedding's partials and the head's logits
    out = (n * d * e + rows * vp // t * e) if vp % t == 0 else 0
    ffn = n * d * e

    def attend(leaf, cap):  # a cache leaf's exchange, where over "model"
        axis, level = leaf
        return (_attend_bytes(cfg, t, n, e, axis, cap)
                if level == "model" else 0)

    if cfg.attention_mixer == "rwkv6":
        layer = mixers.init_rwkv6(None, cfg, "meta")
        aligned = leaves[0] == (1, "model")  # the state on the heads
        if prompt:
            mixer = (_gathered_bytes(layer, t, ("mu",)) + n * d * 4
                     + n * d * e)
            if not aligned:
                mixer += rows * (h // t) * (d // h) ** 2 * 4
        else:
            mixer = 5 * n * d // t * e + n * d * 4 + n * d * e
            if not aligned:
                mixer += 4 * n * d // t * 4
            if leaves[0] == (2, "model"):
                mixer += n * d * 4
    elif cfg.attention_mixer == "hymba":
        layer = mixers.init_hymba(None, cfg, "meta")
        if prompt:
            names = ("wq", "wk", "wv", "bq", "bk", "bv")
            mixer = (_gathered_bytes(layer["attn"], t, names)
                     + _gathered_bytes(layer["ssm"], t, tuple(layer["ssm"]))
                     + _gathered_bytes(layer, t, ("ln_attn",)) + n * d * e)
        else:
            cap = min(cache_len, cfg.sliding_window or cache_len)
            mixer = (_qkv_bytes(layer["attn"], t, n, e)
                     + attend(leaves[0], cap)
                     + _cols_bytes(layer["ssm"], ("wx", "wbc", "wdt"), t, n,
                                   e)
                     + (n * h * hd // t * e if leaves[2][1] == "model"
                        else 0)
                     + (n * h * hd // t * e
                        if _split(layer, "ln_attn", t) else 0)
                     + n * d * e)
    else:
        cap = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
               else cache_len)
        if prompt:
            mixer = (_prefill_attention_bytes(cfg, t, n, e)
                     + _kv_bytes(whole, t, n, e))
        else:
            mixer = (_qkv_bytes(whole, t, n, e) + attend(leaves[-1], cap)
                     + n * d * e)
    block = mixer + ffn
    encoder = 0
    if cfg.is_encdec:
        frames = rows * cfg.encoder_seq
        if prompt:
            block += (_prefill_attention_bytes(cfg, t, n, e)
                      + _kv_bytes(whole, t, frames, e))
            encoder = cfg.encoder_layers * (
                _prefill_attention_bytes(cfg, t, frames, e)
                + frames * d * e)
        else:  # tree order: "cross" before "mixer"
            block += (_cols_bytes(whole, ("wq",), t, n, e)
                      + attend(leaves[1], cfg.encoder_seq) + n * d * e)
    return shards * (out + cfg.num_layers * block + encoder)


def serve_joint_bytes(cfg, rows: int, cache_len: int, mesh,
                      parts: int) -> int:
    """What a process holding `parts` of the C x T joint parts sends the
    joint group (every process) to decode one token of a batch of `rows`
    requests that `mesh`'s C client ranks do not share, from a cache of
    `cache_len` (none at the prefill, and none where no leaf splits
    jointly). For each leaf split jointly, each part's share, a layer:

    - an attention cache (self, hymba's ring, whisper's cross):
      `attend_by_shard`'s part over C x T parts (the slots' f32
      statistics rows x H x (hd + 2), or head_dim's f32 scores rows x H x
      slots and its slice of the output);
    - rwkv6's x_prev: its d_model slice; its state: the f32 reads of its
      heads (rows x H / CT x hd x 4 B), or of its key rows, a partial of
      every head (rows x d_model x 4 B);
    - hymba's SSD state: its head_dim slice of the SSD output."""
    e = torch.finfo(cfg.dtype).bits // 8
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    t = int(mesh.shape["model"])
    leaves, p = _levels(cfg, rows, cache_len, t, mesh)
    n = rows

    def attend(leaf, cap):
        axis, level = leaf
        return (_attend_bytes(cfg, p, n, e, axis, cap)
                if level == "joint" else 0)

    if cfg.attention_mixer == "rwkv6":
        (s_axis, s_level), (_, x_level) = leaves
        block = n * d // p * e if x_level == "joint" else 0
        if s_level == "joint":
            block += (n * h // p * hd * 4 if s_axis == 1 else n * d * 4)
    elif cfg.attention_mixer == "hymba":
        cap = min(cache_len, cfg.sliding_window or cache_len)
        block = (attend(leaves[0], cap)
                 + (n * h * hd // p * e if leaves[2][1] == "joint" else 0))
    else:
        cap = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
               else cache_len)
        block = attend(leaves[-1], cap)
        if cfg.is_encdec:
            block += attend(leaves[1], cfg.encoder_seq)
    return parts * cfg.num_layers * block


def _qkv_bytes(layer, t: int, n: int, e: int) -> int:
    return _cols_bytes(layer, ("wq", "wk", "wv"), t, n, e)


def _kv_bytes(layer, t: int, n: int, e: int) -> int:
    return _cols_bytes(layer, ("wk", "wv"), t, n, e)


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
    return take_model_shards(tree, agg.model_axes, agg.local_shards,
                             agg.model_size, lead)


def take_model_shards(tree, axes, shards: slice, t: int, lead: int = 0):
    """Shards `shards` of T of each leaf split on its axis of `axes`
    (None: whole), copied out; the tree itself for all T."""
    if shards == slice(0, t):
        return tree
    leaves, unflatten = tree_flatten(tree)
    out = []
    for x, ax in zip(leaves, axes):
        if ax is not None:
            n = x.shape[lead + ax] // t
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
