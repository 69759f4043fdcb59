"""Model assembly for every family (port of `repro.models.transformer`):

  dense  — GQA + RoPE (+ sliding window / QKV bias)
  moe    — dense attention + the capacity-free top-k MoE FFN (`moe.py`)
  ssm    — the RWKV6 mixer, attention-free
  hybrid — Hymba's parallel attention and SSD heads
  vlm    — qwen2-vl: M-RoPE, patch-embedding stub spliced into the stream
  audio  — whisper: bidirectional encoder over a frame-embedding stub and a
           causal decoder with cross-attention

Layer parameters are stacked over layers (a leading L axis, as the
reference scans them). The parameter tree is the reference's, key for key:
its top level in the reference's order, every dict below it in sorted key
order (as `jax.vmap` returns the reference's blocks), e.g. for the dense
family:

    {"embed": (Vp, D), "blocks": {"ffn": {w_down, w_gate, w_up},
     "ln1": {bias, scale}, "ln2": {bias, scale}, "mixer": {wk, wo, wq, wv}},
     "final_norm": {bias, scale}, "lm_head": (Vp, D)}

so `core.api.tree_flatten` visits the leaves in JAX's order and the wire's
per-leaf draws land on the same leaves on both sides. Entry points:

    init_params(seed, cfg, device=None)          -> params
    forward(params, batch, cfg)                  -> logits
    loss_fn(params, batch, cfg, ce=...)          -> scalar loss
    prefill(params, batch, cfg, cache_len=...)   -> (last logits, cache)
    init_cache(params, cfg, batch=, cache_len=)  -> zero cache
    decode_step(params, cache, tokens, pos, cfg) -> (logits, cache)

With `ms` (`models.tp.ModelShards`, T > 1) prefill and decode_step
compute on the process's model shards of the parameters and of the cache,
which lies split as the reference's `cache_specs` lays it (`ms.cache_axes`
and `ms.cache_joint`: over the model shards, or over the client ranks and
the model shards jointly; `init_cache(..., shards=ms)` gives the process's
slice).

batch: {"tokens": (B, S + 1)} (the prompt (B, S) for prefill), plus
"patches" (B, P, D) for the VLM and "frames" (B, T_enc, D) for the
encoder-decoder. A cache is {"mixer": the mixer's cache, "cross": AttnCache
for the encoder-decoder}, every leaf stacked over layers (a leading L
axis). Prefill and decode run under `torch.inference_mode()`; decode_step
writes each layer's token into that layer's slice of the cache in place
(the reference's serve step donates its cache) and returns the same cache.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.core.api import tree_flatten, tree_leaves
from repro_torch.device import resolve_device
from repro_torch.models import mixers, tp
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    embed_tokens,
    embed_tokens_tp,
    init_mlp,
    init_norm,
    lm_logits,
    mlp,
    mlp_by_shard,
    norm,
    normal,
    token_nll,
    vocab_logits,
    vocab_parallel_nll,
)
from repro_torch.models.moe import init_moe, moe_ffn, moe_ffn_tp

_MIXERS = ("attn", "rwkv6", "hymba")
_F32 = torch.float32


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _init_block(gen, cfg: ArchConfig, dev, lead):
    if cfg.num_experts:
        ffn = init_moe(gen, cfg, dev, lead)
    else:
        ffn = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.dtype, dev,
                       lead)
    if cfg.attention_mixer == "attn":
        mixer = mixers.init_attention(gen, cfg, dev, lead)
    elif cfg.attention_mixer == "rwkv6":
        mixer = mixers.init_rwkv6(gen, cfg, dev, lead)
    elif cfg.attention_mixer == "hymba":
        mixer = mixers.init_hymba(gen, cfg, dev, lead)
    else:
        raise ValueError(f"unknown attention_mixer {cfg.attention_mixer!r}; "
                         f"options: {_MIXERS}")
    p = {"ffn": ffn, "mixer": mixer,
         "ln1": init_norm(cfg.d_model, cfg.norm, cfg.dtype, dev, lead),
         "ln2": init_norm(cfg.d_model, cfg.norm, cfg.dtype, dev, lead)}
    if cfg.is_encdec:
        p["cross"] = mixers.init_attention(gen, cfg, dev, lead)
        p["ln_cross"] = init_norm(cfg.d_model, cfg.norm, cfg.dtype, dev, lead)
    return p


def _init_encoder_block(gen, cfg: ArchConfig, dev, lead):
    return {"ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.dtype,
                            dev, lead),
            "mixer": mixers.init_attention(gen, cfg, dev, lead),
            "ln1": init_norm(cfg.d_model, cfg.norm, cfg.dtype, dev, lead),
            "ln2": init_norm(cfg.d_model, cfg.norm, cfg.dtype, dev, lead)}


def init_params(seed, cfg: ArchConfig, device=None):
    """Random parameters in cfg.dtype (the f32 leaves of the reference in
    f32), drawn from `seed` (an int or a torch.Generator on `device`;
    device="meta" gives the shapes alone). The reference's shapes and
    scales (normal * 0.02 for the tables, normal / sqrt(fan_in) for the
    projections); the numbers differ, as any two generators do."""
    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    elif dev.type == "meta":  # shapes only (wire accounting): nothing drawn
        gen = None
    else:
        # analysis: allow[rng-unstructured-seed] an int seed is a caller's
        # fixed stream (tests, sizing, tools); the trainer passes core.salts'
        # generator
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    d, vp = cfg.d_model, cfg.padded_vocab()
    blocks = _init_block(gen, cfg, dev, (cfg.num_layers,))
    # the top level in the reference's order; every dict below it sorted
    p: dict[str, Any] = {
        "embed": normal(gen, (vp, d), 0.02, cfg.dtype, dev),
        "blocks": blocks,
        "final_norm": init_norm(d, cfg.norm, cfg.dtype, dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal(gen, (vp, d), 0.02, cfg.dtype, dev)
    if cfg.is_encdec:
        p["enc_blocks"] = _init_encoder_block(gen, cfg, dev,
                                              (cfg.encoder_layers,))
        p["enc_final_norm"] = init_norm(d, cfg.norm, cfg.dtype, dev)
        # whisper: learned decoder positions, sinusoidal encoder positions
        p["pos_embed"] = normal(gen, (cfg.max_seq, d), 0.02, cfg.dtype, dev)
    return {k: _sorted(v) for k, v in p.items()}


# -- positions (RoPE streams; M-RoPE for the VLM) --------------------------------

def mrope_grid(cfg: ArchConfig) -> int:
    return max(1, int(math.ceil(math.sqrt(max(cfg.vision_patches, 1)))))


def mrope_positions(cfg: ArchConfig, s: int, b: int, device=None):
    """(3, B, S) t/h/w position ids: the patch grid, then the text."""
    g = mrope_grid(cfg)
    i = torch.arange(s, device=device)
    is_patch = i < cfg.vision_patches
    text = g + (i - cfg.vision_patches)
    t = torch.where(is_patch, 0, text)
    h = torch.where(is_patch, i // g, text)
    w = torch.where(is_patch, i % g, text)
    return torch.stack([t, h, w])[:, None, :].expand(3, b, s)


def _positions(cfg: ArchConfig, b: int, s: int, device):
    if cfg.mrope_sections is not None:
        return mrope_positions(cfg, s, b, device)
    return torch.arange(s, device=device).expand(b, s)


def _decode_rope_positions(cfg: ArchConfig, b: int, pos):
    """The rotation stream of a decode token at position `pos` (a 0-d
    tensor): (B, 1), or (3, B, 1) for M-RoPE, whose text positions run
    from the patch grid's side g on: g + (pos - vision_patches) on all
    three streams."""
    if cfg.mrope_sections is not None:
        eff = mrope_grid(cfg) + (pos - cfg.vision_patches)
        return eff.expand(3, b, 1)
    return pos.expand(b, 1)


def _sinusoid(s: int, d: int, dtype, device=None):
    pos = torch.arange(s, device=device)[:, None].to(torch.float32)
    dim = torch.arange(0, d, 2, device=device)[None].to(torch.float32)
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# -- blocks ------------------------------------------------------------------------

def _ffn(bp, x, cfg: ArchConfig, ms: tp.ModelShards | None = None):
    if cfg.num_experts:
        if ms is not None:
            return moe_ffn_tp(bp["ffn"], x, cfg, ms)
        return moe_ffn(bp["ffn"], x, cfg)
    return mlp(x, bp["ffn"], cfg.act, ms)


def _block_train(bp, x, cfg: ArchConfig, positions, enc,
                 ms: tp.ModelShards | None = None):
    """One layer over the sequence; with `ms`, on the process's model
    shards (`models.tp`)."""
    h = norm(x, bp["ln1"], cfg.norm)
    if cfg.attention_mixer == "attn":
        y = (mixers.attention_train(bp["mixer"], h, cfg, positions=positions)
             if ms is None else mixers.attention_train_tp(
                 bp["mixer"], h, cfg, ms, positions=positions))
    elif cfg.attention_mixer == "rwkv6":
        y = (mixers.rwkv6_train(bp["mixer"], h, cfg) if ms is None
             else mixers.rwkv6_train_tp(bp["mixer"], h, cfg, ms))
    else:
        y = (mixers.hymba_train(bp["mixer"], h, cfg, positions=positions)
             if ms is None else mixers.hymba_train_tp(
                 bp["mixer"], h, cfg, ms, positions=positions))
    x = x + y
    if cfg.is_encdec:
        hc = norm(x, bp["ln_cross"], cfg.norm)
        x = x + (mixers.cross_attention_train(bp["cross"], hc, enc, cfg)
                 if ms is None else mixers.cross_attention_train_tp(
                     bp["cross"], hc, enc, cfg, ms))
    return x + _ffn(bp, norm(x, bp["ln2"], cfg.norm), cfg, ms)


def _block_prefill(bp, x, cfg: ArchConfig, positions, enc, cache_len: int):
    h = norm(x, bp["ln1"], cfg.norm)
    if cfg.attention_mixer == "attn":
        y, c = mixers.attention_prefill(bp["mixer"], h, cfg,
                                        positions=positions,
                                        cache_len=cache_len)
    elif cfg.attention_mixer == "rwkv6":
        y, c = mixers.rwkv6_prefill(bp["mixer"], h, cfg)
    else:
        y, c = mixers.hymba_prefill(bp["mixer"], h, cfg, positions=positions,
                                    cache_len=cache_len)
    x = x + y
    cache = {"mixer": c}
    if cfg.is_encdec:
        hc = norm(x, bp["ln_cross"], cfg.norm)
        x = x + mixers.cross_attention_train(bp["cross"], hc, enc, cfg)
        cache["cross"] = mixers.cross_attention_cache(bp["cross"], enc, cfg)
    return x + _ffn(bp, norm(x, bp["ln2"], cfg.norm), cfg), cache


def _block_decode(bp, x, cfg: ArchConfig, cache, pos, rope_pos):
    """One layer of one token; writes the layer's cache in place."""
    h = norm(x, bp["ln1"], cfg.norm)
    if cfg.attention_mixer == "attn":
        y, _ = mixers.attention_decode(bp["mixer"], h, cfg, cache["mixer"],
                                       pos, rope_positions=rope_pos)
    elif cfg.attention_mixer == "rwkv6":
        y, _ = mixers.rwkv6_decode(bp["mixer"], h, cfg, cache["mixer"])
    else:
        y, _ = mixers.hymba_decode(bp["mixer"], h, cfg, cache["mixer"], pos)
    x = x + y
    if cfg.is_encdec:
        hc = norm(x, bp["ln_cross"], cfg.norm)
        x = x + mixers.cross_attention_decode(bp["cross"], hc, cfg,
                                              cache["cross"])
    return x + _ffn(bp, norm(x, bp["ln2"], cfg.norm), cfg)


def _unbind(tree: Any):
    """Each stacked leaf unbound once: the layers' views (a split leaf's
    shards each unbound once)."""
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    if isinstance(tree, tp.Sharded):
        return tree.unbind()
    if hasattr(tree, "_fields"):  # a cache NamedTuple
        return type(tree)(*(_unbind(v) for v in tree))
    return tree.unbind(0)


def _layer(tree: Any, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_layer(v, i) for v in tree))
    return tree[i]


def _full(remat) -> bool:
    return remat is True or remat == "full"


class _Keep(torch.autograd.Function):
    """x unchanged; what it saves for the backward is the process's
    shards' rows of x's sequence (`ModelShards.seq_rows`, a copy; x
    itself where the process holds every shard): the stash of the block
    that reads it (`_stashed`)."""

    @staticmethod
    def forward(ctx, x, ms):
        if ms is None or not ms.spread:
            ctx.save_for_backward(x)
        else:
            lo, hi = ms.seq_rows(x.shape[1])
            ctx.save_for_backward(x[:, lo:hi].clone())
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Holder:
    """A tensor the block saved in its forward, dropped until its
    recompute fills it (weak-referenced by the block's `_Stash`)."""

    __slots__ = ("value", "__weakref__")

    def __init__(self):
        self.value = None


class _Recomputed(Exception):
    """The recompute has refilled every saved tensor: stop it there."""


class _Stash:
    """One block under remat "full": its forward saves no tensor of its
    own (each one autograd saves becomes an empty `_Holder`) and keeps
    only `_Keep`'s rows of its input. The first of its saved
    tensors its backward reads puts the input whole again
    (`tp.seq_whole`, over the model group) and reruns the block, filling
    the holders in the order they were saved, and stops after the last
    (before the block's last reduction over the shards, as
    `torch.utils.checkpoint` stops). The block's graph is the forward's:
    the gradient of its input is whole, the same on every shard."""

    def __init__(self, body, bp, ms, s: int):
        self.body, self.bp, self.ms, self.s = body, bp, ms, s
        self.holders: list = []
        self.keep = None  # `_Keep`'s node, which holds the rows
        self.filled = 0

    def pack(self, _t):
        h = _Holder()
        self.holders.append(weakref.ref(h))
        return h

    def unpack(self, h):
        if h.value is None:
            self._recompute()
        return h.value

    def _refill(self, t):
        h = self.holders[self.filled]()
        if h is not None:
            h.value = t.detach() if t.requires_grad else t
        self.filled += 1
        if self.filled == len(self.holders):
            raise _Recomputed

    def _recompute(self):
        part, = self.keep.saved_tensors
        self.keep = None
        x = tp.seq_whole(part, self.ms, self.s).detach()
        x.requires_grad_(True)
        self.filled = 0
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                self._refill, _no_unpack):
            try:
                self.body(self.bp, x)
            except _Recomputed:
                pass
        if self.filled != len(self.holders):
            raise RuntimeError(f"the recompute saved {self.filled} tensors, "
                               f"the forward {len(self.holders)}")


def _no_unpack(_h):
    raise RuntimeError("a recomputed block's own graph is never run")


def _stashed(body, bp, x, ms: tp.ModelShards | None):
    """body(bp, x) keeping only the rows of x's sequence that `ms`'s
    shards hold for its backward (`_Stash`; all of them without `ms`)."""
    if not x.requires_grad:  # nothing to keep for a gradient of x
        return torch.utils.checkpoint.checkpoint(body, bp, x,
                                                 use_reentrant=False)
    frame = _Stash(body, bp, ms, x.shape[1])
    kept = _Keep.apply(x, ms)
    frame.keep = kept.grad_fn
    with torch.autograd.graph.saved_tensors_hooks(frame.pack, frame.unpack):
        return body(bp, kept)


def _run_blocks(blocks, x, body, remat, decoder=False, stash=None):
    """x through each layer of the stacked `blocks`: body(bp, x) -> x.

    One unbind per stacked leaf: its backward stacks the layers' gradients
    in one pass, where indexing layer by layer would add L full-size
    zero-padded gradients per leaf. remat True/"full" recomputes each
    block's activations in the backward pass, which changes no number:
    a decoder block keeps its input for it (`_stashed`), the rows of its
    sequence that `stash`'s shards hold (`tp.ModelShards`, the train
    step's `seq_shard`) or all of them; an encoder block its whole input
    (`torch.utils.checkpoint`: the reference's `encode` takes no
    `seq_shard`)."""
    layers = _unbind(blocks)
    n = blocks["ln1"]["scale"].shape[0]
    for i in range(n):
        bp = _layer(layers, i)
        if _full(remat) and decoder and torch.is_grad_enabled():
            x = _stashed(body, bp, x, stash)
        elif _full(remat):
            x = torch.utils.checkpoint.checkpoint(body, bp, x,
                                                  use_reentrant=False)
        else:
            x = body(bp, x)
    return x


def encode(params, frames, cfg: ArchConfig, *, remat="full",
           ms: tp.ModelShards | None = None):
    """frames: (B, T_enc, D) precomputed frame embeddings (the conv-frontend
    stub) -> the encoder's output, bidirectional, sinusoidal positions;
    with `ms` each block's attention and MLP on the process's model shards
    (the frames, the positions and the output replicated)."""
    b, t, _ = frames.shape
    x = frames + _sinusoid(t, cfg.d_model, frames.dtype, frames.device)[None]
    positions = _positions(cfg, b, t, frames.device)

    def body(bp, x):
        h = norm(x, bp["ln1"], cfg.norm)
        if ms is None:
            y = mixers.attention_train(bp["mixer"], h, cfg,
                                       positions=positions, causal=False,
                                       window=None)
        else:
            y = mixers.attention_train_tp(bp["mixer"], h, cfg, ms,
                                          positions=positions, causal=False,
                                          window=None)
        x = x + y
        return x + mlp(norm(x, bp["ln2"], cfg.norm), bp["ffn"], cfg.act, ms)

    x = _run_blocks(params["enc_blocks"], x, body, remat)
    return norm(x, params["enc_final_norm"], cfg.norm)


def _embed_inputs(params, batch, cfg: ArchConfig, inputs,
                  ms: tp.ModelShards | None = None):
    if isinstance(params["embed"], tp.Sharded):
        x = embed_tokens_tp(inputs, params["embed"], ms)
    else:
        x = embed_tokens(inputs, params["embed"])
    if cfg.family == "vlm" and "patches" in batch:
        p = batch["patches"].to(x.dtype)  # (B, P, D) stub embeddings
        x = torch.cat([p, x[:, p.shape[1]:]], dim=1)
    if cfg.is_encdec:
        x = x + params["pos_embed"][:inputs.shape[1]][None]
    return x


def _hidden(params, batch, cfg: ArchConfig, remat,
            ms: tp.ModelShards | None = None, seq_shard: bool = False):
    """The last block's output over the input tokens (all but the last);
    with `ms`, the layers on the process's model shards (the parameters'
    split leaves `tp.Sharded`); with `seq_shard` (and remat "full") each
    decoder block keeps only the process's rows of its input's sequence
    for the backward (`_stashed`)."""
    tokens = batch["tokens"]
    inputs = tokens[:, :-1] if tokens.shape[1] > 1 else tokens
    b, s = inputs.shape
    enc = (encode(params, batch["frames"], cfg, remat=remat, ms=ms)
           if cfg.is_encdec else None)
    x = _embed_inputs(params, batch, cfg, inputs, ms)
    positions = _positions(cfg, b, s, x.device)
    return _run_blocks(
        params["blocks"], x,
        lambda bp, x: _block_train(bp, x, cfg, positions, enc, ms), remat,
        decoder=True, stash=ms if seq_shard else None)


def _final_norm(params, x, cfg: ArchConfig, remat, seq_shard: bool,
                ms: tp.ModelShards | None):
    """The final norm of the last block's output, which with `seq_shard`
    (and remat "full") keeps only the process's rows of it, as each
    block keeps its input's (the reference's scan carries the residual
    split over "model" out of its last layer too)."""
    if seq_shard and _full(remat) and torch.is_grad_enabled():
        return _stashed(lambda p, x: norm(x, p, cfg.norm),
                        params["final_norm"], x, ms)
    return norm(x, params["final_norm"], cfg.norm)


def _head(params, x, cfg: ArchConfig):
    table = params.get("lm_head", params["embed"])
    return lm_logits(norm(x, params["final_norm"], cfg.norm), table,
                     cfg.vocab)


def _streaming_ce(logits, labels, true_vocab: int):
    """Per-token CE in f32 without a gather over the vocab: the gold logit
    by an iota == label masked sum, the pad ids kept out of the logsumexp
    by the same predicate, the max taken without a gradient (the
    reference's vocab-parallel form)."""
    l32 = logits.to(_F32)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    valid = iota < true_vocab
    neg = torch.tensor(-1e30, dtype=_F32, device=logits.device)
    m = torch.amax(torch.where(valid, l32, neg), dim=-1).detach()
    ex = torch.exp(torch.where(valid, l32 - m[..., None], neg))
    logz = m + torch.log(torch.sum(ex, dim=-1))
    gold = torch.sum(torch.where(iota == labels[..., None], l32, 0.0), dim=-1)
    return logz - gold


def forward(params, batch, cfg: ArchConfig, *, remat="full"):
    """Teacher-forced logits over the input tokens (all but the last)."""
    return _head(params, _hidden(params, batch, cfg, remat), cfg)


_CE = ("gather", "streaming")


def loss_fn(params, batch, cfg: ArchConfig, *, remat="full",
            ce: str = "gather", ms: tp.ModelShards | None = None,
            seq_shard: bool = False):
    """Mean next-token cross entropy in f32; for the VLM with patches, over
    the text positions only. ce="gather" takes the gold logit by a gather
    from the masked logits; ce="streaming" is the reference's
    vocab-parallel form over the unmasked ones (`_streaming_ce`).

    With `ms` (T > 1 model shards, `models.tp`) the layers of every
    family compute on the process's shards of `params` (whose split
    leaves hold those shards only); both ce forms are then the
    vocab-parallel CE (`layers.vocab_parallel_nll`) where the head's
    table is split.

    `seq_shard` (the reference's, `loss_fn(seq_shard=)`): under remat
    "full" each decoder block, and the final norm, keeps for the backward
    only the rows of its input's sequence that the process's shards hold
    (ceil(S / T) a shard), where the reference constrains the block's
    input to `P(None, "model", None)`; the backward puts them together
    again over the model group. It changes no number, and without remat
    nothing at all."""
    if ce not in _CE:
        raise ValueError(f"unknown ce {ce!r}; options: {_CE}")
    labels = batch["tokens"][:, 1:]
    if ms is not None:
        params = ms.split(params)
    x = _final_norm(params, _hidden(params, batch, cfg, remat, ms, seq_shard),
                    cfg, remat, seq_shard, ms)
    table = params.get("lm_head", params["embed"])
    if isinstance(table, tp.Sharded):
        nll = vocab_parallel_nll(x, table, labels, cfg.vocab, ms)
    elif ce == "streaming":
        nll = _streaming_ce(torch.matmul(x, table.t()), labels, cfg.vocab)
    else:
        nll = token_nll(lm_logits(x, table, cfg.vocab), labels, cfg.vocab)
    if not (cfg.family == "vlm" and "patches" in batch):
        return torch.mean(nll)
    mask = (torch.arange(labels.shape[1], device=nll.device)
            >= batch["patches"].shape[1]).to(torch.float32)
    mask = mask[None, :].expand(nll.shape)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# -- serving: prefill, the cache, one-token decode -----------------------------------

@torch.inference_mode()
def prefill(params, batch, cfg: ArchConfig, *, cache_len: int,
            ms: tp.ModelShards | None = None):
    """Consume the prompt batch["tokens"] (B, S): (the last token's logits
    (B, 1, Vp), the cache stacked over layers). Each layer's cache is
    written into its slice of the stacked one as the layer finishes. With
    `ms` the layers compute on the process's model shards as the training
    forward does (`_block_prefill_tp`) and the cache is the process's
    slice (`init_cache(..., shards=ms)`)."""
    if ms is not None:
        return _prefill_tp(params, batch, cfg, cache_len, ms)
    inputs = batch["tokens"]
    b, s = inputs.shape
    enc = (encode(params, batch["frames"], cfg, remat=False)
           if cfg.is_encdec else None)
    x = _embed_inputs(params, batch, cfg, inputs)
    positions = _positions(cfg, b, s, x.device)
    layers = _unbind(params["blocks"])
    n = cfg.num_layers
    stacked = None
    for i in range(n):
        x, cache = _block_prefill(_layer(layers, i), x, cfg, positions, enc,
                                  cache_len)
        leaves, unflatten = tree_flatten(cache)
        if stacked is None:
            stacked = [torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                   device=t.device) for t in leaves]
        for dst, src in zip(stacked, leaves):
            dst[i].copy_(src)
        del cache, leaves
    return _head(params, x[:, -1:], cfg), unflatten(stacked)


def _zero_cache(cfg: ArchConfig, b: int, cache_len: int, dev):
    n = cfg.num_layers
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    window = cfg.sliding_window
    cap = min(cache_len, window) if window else cache_len

    def zeros(shape, dt=cfg.dtype):
        return torch.zeros((n, b) + shape, dtype=dt, device=dev)

    def attn_cache(c=cap):
        return mixers.AttnCache(zeros((c, kh, hd)), zeros((c, kh, hd)))

    if cfg.attention_mixer == "attn":
        cache: dict[str, Any] = {"mixer": attn_cache()}
    elif cfg.attention_mixer == "rwkv6":
        h = cfg.num_heads
        rhd = cfg.d_model // h
        cache = {"mixer": mixers.Rwkv6Cache(zeros((h, rhd, rhd), _F32),
                                            zeros((cfg.d_model,)))}
    else:
        cache = {"mixer": mixers.HymbaCache(
            attn_cache(),
            zeros((cfg.num_heads, cfg.ssm_state, cfg.head_dim), _F32))}
    if cfg.is_encdec:
        cache["cross"] = attn_cache(cfg.encoder_seq)
    return cache


def init_cache(params, cfg: ArchConfig, *, batch: int, cache_len: int,
               shards: tp.ModelShards | None = None):
    """Zeros in the shapes and dtypes `prefill` gives (the state leaves in
    f32, the rest in cfg.dtype), on the parameters' device, every leaf
    with the leading layer axis. With `shards`, one process's slice: each
    leaf its parts on its split axis (`shards.cache_axes`: its model
    shards, or its joint parts of the client ranks x model shards,
    `shards.cache_parts`); `batch` the process's rows."""
    dev = tree_leaves(params)[0].device
    if shards is None:
        return _zero_cache(cfg, batch, cache_len, dev)
    leaves, unflatten = tree_flatten(_zero_cache(cfg, batch, cache_len,
                                                 "meta"))
    _cache_axes(shards, len(leaves))
    out = []
    for i, (x, ax) in enumerate(zip(leaves, shards.cache_axes)):
        shape = list(x.shape)
        if ax is not None:
            parts = shards.cache_parts(i)
            shape[ax] = shape[ax] // parts.size * parts.count
        out.append(torch.zeros(shape, dtype=x.dtype, device=dev))
    return unflatten(out)


def cache_slice(cache, ms: tp.ModelShards):
    """A process's slice of a whole cache (its requests' rows), copied
    out: each split leaf's parts the process holds (`ms.cache_parts`),
    each whole leaf itself; what `prefill(..., ms=ms)` leaves it."""
    leaves, unflatten = tree_flatten(cache)
    _cache_axes(ms, len(leaves))
    return unflatten([x if ax is None else
                      ms.cache_parts(i).take(x, ax).clone()
                      for i, (x, ax) in enumerate(zip(leaves,
                                                      ms.cache_axes))])


def _cache_axes(ms: tp.ModelShards, n: int) -> tuple:
    if len(ms.cache_axes) != n:
        raise ValueError(f"{n} cache leaves, split axes for "
                         f"{len(ms.cache_axes)} (launch.sharding.cache_axes)")
    return ms.cache_axes


@torch.inference_mode()
def decode_step(params, cache, tokens, pos, cfg: ArchConfig,
                ms: tp.ModelShards | None = None):
    """One decode step: tokens (B, 1) at absolute position `pos` (an int or
    a 0-d integer tensor, never read back to the host) -> (logits (B, 1,
    Vp), cache). The cache is updated in place, layer by layer through one
    unbind of each stacked leaf, and returned. The encoder-decoder's
    learned position clamps past its table's end, as the reference's
    dynamic_slice does. With `ms`, on the process's model shards of the
    parameters and its slice of the cache (`_block_decode_tp`)."""
    if ms is not None:
        params = ms.split(params)
    b, host_pos = tokens.shape[0], pos
    if isinstance(params["embed"], tp.Sharded):
        x = embed_tokens_tp(tokens, params["embed"], ms)
    else:
        x = embed_tokens(tokens, params["embed"])
    pos = mixers._as_pos(pos, x.device)
    if cfg.is_encdec:
        table = params["pos_embed"]
        row = torch.clamp(pos, 0, table.shape[0] - 1).reshape(1)
        x = x + table.index_select(0, row)[None]
    rope_pos = _decode_rope_positions(cfg, b, pos)
    layers = _unbind(params["blocks"])
    if ms is None:
        caches = _unbind(cache)
        for i in range(cfg.num_layers):
            x = _block_decode(_layer(layers, i), x, cfg, _layer(caches, i),
                              pos, rope_pos)
        return _head(params, x, cfg), cache
    shard_caches, splits = _cache_by_shard(cache, ms)
    if not torch.is_tensor(host_pos):  # an int stays on the host
        pos = int(host_pos)
    for i in range(cfg.num_layers):
        x = _block_decode_tp(_layer(layers, i), x, cfg, shard_caches[i],
                             splits, pos, rope_pos, ms)
    return _head_tp(params, x, cfg, ms), cache


# -- serving on the model shards ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Split:
    """A cache leaf's layout in one layer: the axis of a request row's
    leaf split into `parts` (None: whole, one part)."""

    axis: int | None
    parts: tp.Parts


def _layer_splits(ms: tp.ModelShards, n: int, unflatten):
    """Each cache leaf's `Split`, in the cache's structure."""
    axes = _cache_axes(ms, n)
    return unflatten([Split(None if a is None else a - 1, ms.cache_parts(i))
                      for i, a in enumerate(axes)])


def _cache_by_shard(cache, ms: tp.ModelShards):
    """([each layer's cache tree, each leaf the tuple of views of the
    parts the process holds], each leaf's `Split`, in the cache's
    structure)."""
    leaves, unflatten = tree_flatten(cache)
    splits = _layer_splits(ms, len(leaves), unflatten)

    def views(x, sp):
        if sp.axis is None:
            return (x,)
        n = x.shape[sp.axis] // sp.parts.count
        return tuple(x.narrow(sp.axis, j * n, n)
                     for j in range(sp.parts.count))

    per_layer = [x.unbind(0) for x in leaves]
    return [unflatten([views(layer[i], sp) for layer, sp in
                       zip(per_layer, tree_leaves(splits))])
            for i in range(len(per_layer[0]))], splits


def _head_tp(params, x, cfg: ArchConfig, ms: tp.ModelShards):
    """The logits (B, S, Vp) over the vocab-parallel head, put together."""
    table = params.get("lm_head", params["embed"])
    return vocab_logits(norm(x, params["final_norm"], cfg.norm), table,
                        cfg.vocab, ms)


def _block_prefill_tp(bp, x, cfg: ArchConfig, positions, enc, cache_len: int,
                      ms: tp.ModelShards, splits):
    """`_block_prefill` on the process's model shards: the layer as the
    training forward computes it by shard, and the layer's cache, whole
    (rwkv6's state split over the model shards on its heads: each shard's
    own, `tp.Sharded`)."""
    h = norm(x, bp["ln1"], cfg.norm)
    if cfg.attention_mixer == "attn":
        y = mixers.attention_train_tp(bp["mixer"], h, cfg, ms,
                                      positions=positions)
        c = mixers.attention_cache_tp(bp["mixer"], h, cfg, ms,
                                      positions=positions,
                                      cache_len=cache_len)
    elif cfg.attention_mixer == "rwkv6":
        state = splits["mixer"].state
        y, c = mixers.rwkv6_prefill_tp(
            bp["mixer"], h, cfg, ms,
            state.axis if state.parts.level == "model" else None)
    else:
        y, c = mixers.hymba_prefill_tp(bp["mixer"], h, cfg, ms,
                                       positions=positions,
                                       cache_len=cache_len)
    x = x + y
    cache = {"mixer": c}
    if cfg.is_encdec:
        hc = norm(x, bp["ln_cross"], cfg.norm)
        x = x + mixers.cross_attention_train_tp(bp["cross"], hc, enc, cfg, ms)
        cache["cross"] = mixers.cross_attention_cache_tp(bp["cross"], enc,
                                                         cfg, ms)
    return x + _ffn(bp, norm(x, bp["ln2"], cfg.norm), cfg, ms), cache


def _prefill_tp(params, batch, cfg: ArchConfig, cache_len: int,
                ms: tp.ModelShards):
    """`prefill` on the process's model shards: each layer's whole cache
    cut to the process's parts as it finishes (after prefill no cache
    byte crosses a group)."""
    inputs = batch["tokens"]
    b, s = inputs.shape
    out = init_cache(params, cfg, batch=b, cache_len=cache_len, shards=ms)
    params = ms.split(params)
    enc = (encode(params, batch["frames"], cfg, remat=False, ms=ms)
           if cfg.is_encdec else None)
    x = _embed_inputs(params, batch, cfg, inputs, ms)
    positions = _positions(cfg, b, s, x.device)
    dst, unflatten = tree_flatten(out)
    splits = _layer_splits(ms, len(dst), unflatten)
    layers = _unbind(params["blocks"])
    for i in range(cfg.num_layers):
        x, cache = _block_prefill_tp(_layer(layers, i), x, cfg, positions,
                                     enc, cache_len, ms, splits)
        for d, src, sp in zip(dst, tree_leaves(cache), tree_leaves(splits)):
            if isinstance(src, tp.Sharded):
                src = torch.cat(list(src.data.unbind(0)), dim=src.axis)
            elif sp.axis is not None:
                src = sp.parts.take(src, sp.axis)
            d[i].copy_(src)
        del cache
    return _head_tp(params, x[:, -1:], cfg, ms), out


def _block_decode_tp(bp, x, cfg: ArchConfig, caches, splits, pos, rope_pos,
                     ms: tp.ModelShards):
    """`_block_decode` on the process's model shards; `caches` the layer's
    cache, each leaf the views of the parts the process holds, `splits`
    each leaf's `Split`."""

    def attn(c):  # an AttnCache of views -> one AttnCache a part
        return [mixers.AttnCache(k, v) for k, v in zip(c.k, c.v)]

    h = norm(x, bp["ln1"], cfg.norm)
    mc, sp = caches["mixer"], splits["mixer"]
    if cfg.attention_mixer == "attn":
        y = mixers.attention_decode_tp(bp["mixer"], h, cfg, attn(mc), sp.k,
                                       pos, ms, rope_positions=rope_pos)
    elif cfg.attention_mixer == "rwkv6":
        y = mixers.rwkv6_decode_tp(bp["mixer"], h, cfg, mc, sp, ms)
    else:
        y = mixers.hymba_decode_tp(bp["mixer"], h, cfg, attn(mc.attn),
                                   mc.ssm_state, (sp.attn.k, sp.ssm_state),
                                   pos, ms)
    x = x + y
    if cfg.is_encdec:
        hc = norm(x, bp["ln_cross"], cfg.norm)
        x = x + mixers.cross_attention_decode_tp(
            bp["cross"], hc, cfg, attn(caches["cross"]), splits["cross"].k,
            ms)
    h = norm(x, bp["ln2"], cfg.norm)
    if cfg.num_experts:
        return x + moe_ffn_tp(bp["ffn"], h, cfg, ms)
    return x + mlp_by_shard(h, bp["ffn"], cfg.act, ms)
