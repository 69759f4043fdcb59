"""Sequence mixers (port of `repro.models.mixers`): softmax attention
(GQA, RoPE or M-RoPE, sliding window), the encoder-decoder's
cross-attention, RWKV6 and Hymba.

Each mixer has the reference's entry points:

    init_<name>(gen, cfg, device, lead)          -> params (leading dims
                                                    `lead`, the layer axis)
    <name>_train(p, x, cfg, ...)                 -> y            (full seq)
    <name>_prefill(p, x, cfg, ...)               -> (y, cache)   (the prompt)
    <name>_decode(p, x, cfg, cache, pos)         -> (y, cache)   (one token)

The caches are the reference's NamedTuples, field for field. A decode step
writes its token into the cache it is given, in place (the reference's
serve step donates its cache), and returns that same cache. `pos`, the
token's absolute position, is an int or a 0-d integer tensor; the decode
path turns it into a tensor on the device and never reads it back.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import tp
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    _gqa_expand,
    apply_mrope,
    apply_rope,
    _bf16_f32,
    chunked_attention,
    cols_whole,
    decode_attention,
    decode_attention_scores,
    decode_attention_values,
    linear,
    linear_col,
    linear_row,
    normal,
    row_sum,
    softmax_stats,
)
from repro_torch.models.linear_attention import (
    LOG_DECAY_CLAMP,
    chunked_linear_attention,
    linear_attention_decode,
)

_F32 = torch.float32


def _normal(gen, shape, cfg: ArchConfig, fan_in: int, device):
    return normal(gen, shape, 1.0 / math.sqrt(fan_in), cfg.dtype, device)


# -- softmax attention (dense / VLM / encoder-decoder self-attention) -----------

class AttnCache(NamedTuple):
    k: torch.Tensor  # (B, C, KH, hd)
    v: torch.Tensor  # (B, C, KH, hd)


def _as_pos(pos, device) -> torch.Tensor:
    """pos as a 0-d int64 tensor on `device`; a Python int is filled in on
    the device (no host-to-device copy, no sync)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64)
    return torch.full((), int(pos), dtype=torch.int64, device=device)


def _fill(cache: AttnCache, k, v, slots) -> None:
    """k, v (B, n, KH, hd) into the cache's slots (n,), in place."""
    cache.k.index_copy_(1, slots, k.to(cache.k.dtype))
    cache.v.index_copy_(1, slots, v.to(cache.v.dtype))


def _empty_cache(x, cap: int, cfg: ArchConfig) -> AttnCache:
    shape = (x.shape[0], cap, cfg.num_kv_heads, cfg.head_dim)
    return AttnCache(torch.zeros(shape, dtype=x.dtype, device=x.device),
                     torch.zeros(shape, dtype=x.dtype, device=x.device))

def init_attention(gen, cfg: ArchConfig, device, lead: tuple[int, ...] = ()):
    """wq, wk, wv, wo (and the biases with `qkv_bias`)."""
    d, hd, qh, kh = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    p = {"wq": _normal(gen, lead + (d, qh * hd), cfg, d, device),
         "wk": _normal(gen, lead + (d, kh * hd), cfg, d, device),
         "wv": _normal(gen, lead + (d, kh * hd), cfg, d, device),
         "wo": _normal(gen, lead + (qh * hd, d), cfg, qh * hd, device)}
    if cfg.qkv_bias:
        for name, width in (("bq", qh * hd), ("bk", kh * hd), ("bv", kh * hd)):
            p[name] = torch.zeros(lead + (width,), dtype=cfg.dtype,
                                  device=device)
    return p


def _qkv(p, x, cfg: ArchConfig):
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = linear(x, p["wq"], p.get("bq")).reshape(b, s, cfg.num_heads, hd)
    k = linear(x, p["wk"], p.get("bk")).reshape(b, s, cfg.num_kv_heads, hd)
    v = linear(x, p["wv"], p.get("bv")).reshape(b, s, cfg.num_kv_heads, hd)
    return q, k, v


def _rotate_one(x, cfg: ArchConfig, positions):
    if cfg.mrope_sections is not None:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    if cfg.rope_theta > 0:
        return apply_rope(x, positions, cfg.rope_theta)
    return x


def _rotate(q, k, cfg: ArchConfig, positions):
    """positions: (B, S), or (3, B, S) for M-RoPE."""
    return _rotate_one(q, cfg, positions), _rotate_one(k, cfg, positions)


def attention_train(p, x, cfg: ArchConfig, *, positions, causal: bool = True,
                    window: int | None | str = "cfg"):
    if window == "cfg":
        window = cfg.sliding_window
    q, k, v = _qkv(p, x, cfg)
    q, k = _rotate(q, k, cfg, positions)
    out = chunked_attention(q, k, v, causal=causal, window=window)
    b, s = x.shape[:2]
    return linear(out.reshape(b, s, -1), p["wo"])


def attention_train_tp(p, x, cfg: ArchConfig, ms: tp.ModelShards, *,
                       positions, causal: bool = True,
                       window: int | None | str = "cfg"):
    """`attention_train` on the process's model shards, by the attention
    case at T (`tp.attention_case`): (a) each shard its column shards of
    wq, wk, wv (whole heads); (b) its q heads from its wq shard, wk and wv
    put together (`tp.whole`) for the kv heads those q heads read; (c)
    every projection put together once (`tp.gathered`) and every head
    computed once on the replicated activations, the output handed to the
    shards (`tp.to_shards`), so the attention's backward sees the whole
    cotangent as the whole layer's does (it rounds cotangents to bf16: a
    shard's part of one would round apart). Each shard hands its rows of
    wo (row-parallel) its rows of the attention output, and the partials
    are summed over the model axis. In cases a and b the shards'
    projections are batched matmuls, and RoPE and the attention run once
    over the shards side by side in the batch."""
    if window == "cfg":
        window = cfg.sliding_window
    return _attention_tp(p, x, x, cfg, ms, positions=positions,
                         causal=causal, window=window)


def _attention_tp(p, x, src, cfg: ArchConfig, ms: tp.ModelShards, *,
                  positions, causal: bool, window: int | None):
    """Attention of the stream x (B, S, D) over the keys and values of
    `src` (x itself, or the encoder's output) on the model shards
    (`attention_train_tp`); positions None: no rotation."""
    b, s, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    case = tp.attention_case(h, kh, ms.size)
    if case == "c":
        q = linear(x, tp.gathered(p["wq"], ms), tp.gathered(p.get("bq"), ms))
        k, v = (linear(src, tp.gathered(p[w], ms),
                       tp.gathered(p.get(bias), ms))
                for w, bias in (("wk", "bk"), ("wv", "bv")))
        q, k, v = (y.reshape(b, y.shape[1], -1, hd) for y in (q, k, v))
        if positions is not None:
            q, k = _rotate(q, k, cfg, positions)
        out = chunked_attention(q, k, v, causal=causal,
                                window=window).reshape(b, s, -1)
        rows = h * hd // ms.size  # a shard's rows of wo
        return linear_row([o[..., j * rows:(j + 1) * rows] for o, j in
                           zip(tp.to_shards(out, ms), ms.shards)],
                          p["wo"], ms, "wo")
    xs = tp.to_shards(x, ms)
    srcs = xs if src is x else tp.to_shards(src, ms)
    c, hq, t = ms.count, h // ms.size, src.shape[1]
    q = linear_col(xs, p["wq"], p.get("bq"), "wq")
    if case == "a":
        k = linear_col(srcs, p["wk"], p.get("bk"), "wk")
        v = linear_col(srcs, p["wv"], p.get("bv"), "wv")
    else:
        rep = h // kh
        k, v = [], []
        none = (None,) * c
        for i, (si, wk, wv, bk, bv) in enumerate(zip(
                srcs, tp.whole(p["wk"], ms), tp.whole(p["wv"], ms),
                tp.whole(p["bk"], ms) if "bk" in p else none,
                tp.whole(p["bv"], ms) if "bv" in p else none)):
            # the kv heads [k0, k1) shard j's q heads [h0, h0 + hq) read,
            # repeated to the q heads they serve and cut to the shard's
            # (the expand's backward sums the copies, in order)
            h0 = ms.shards[i] * hq
            k0, k1 = h0 // rep, (h0 + hq - 1) // rep + 1
            cols = slice(k0 * hd, k1 * hd)
            for out, w, bias in ((k, wk, bk), (v, wv, bv)):
                y = linear(si, w[:, cols].contiguous(),
                           None if bias is None else bias[cols].contiguous())
                y = _gqa_expand(y.reshape(b, t, k1 - k0, hd), rep)
                out.append(y[:, :, h0 - k0 * rep:h0 - k0 * rep + hq])
        k, v = torch.stack(k), torch.stack(v)
    # the shards side by side in the batch: RoPE and the attention act
    # per sequence and head
    q = q.reshape(c * b, s, hq, hd)
    k = k.reshape(c * b, t, -1, hd)
    if positions is not None:
        tiled = (positions.repeat(c, 1) if positions.dim() == 2
                 else positions.repeat(1, c, 1))
        q, k = _rotate(q, k, cfg, tiled)
    out = chunked_attention(q, k, v.reshape(c * b, t, -1, hd),
                            causal=causal, window=window)
    return linear_row(out.reshape(c, b, s, -1), p["wo"], ms, "wo")


def attention_prefill(p, x, cfg: ArchConfig, *, positions, cache_len: int):
    """Causal attention over the prompt, leaving a KV cache of capacity
    `cache_len` (min(cache_len, cfg.sliding_window) with a window). With no
    window, or a prompt that fits, the last tokens sit at slot 0 on; a
    longer prompt under a window is a ring buffer: its last `cap` tokens at
    their pos % cap slots."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q, k = _rotate(q, k, cfg, positions)
    out = chunked_attention(q, k, v, causal=True, window=cfg.sliding_window)
    return (linear(out.reshape(b, s, -1), p["wo"]),
            _prompt_cache(x, k, v, cfg, cache_len))


def _prompt_cache(x, k, v, cfg: ArchConfig, cache_len: int) -> AttnCache:
    """The prompt's rotated k and v (B, S, KH, hd) laid into a cache of
    capacity min(cache_len, window) (`attention_prefill`)."""
    window = cfg.sliding_window
    s = k.shape[1]
    cap = min(cache_len, window) if window is not None else cache_len
    cache = _empty_cache(x, cap, cfg)
    if window is None or s <= cap:
        take = min(s, cap)
        slots = torch.arange(take, device=x.device)
    else:
        take = cap
        slots = torch.arange(s - cap, s, device=x.device) % cap
    _fill(cache, k[:, s - take:], v[:, s - take:], slots)
    return cache


def attention_decode(p, x, cfg: ArchConfig, cache: AttnCache, pos,
                     rope_positions=None):
    """x: (B, 1, D); pos: the token's absolute position. rope_positions
    overrides the rotation stream (M-RoPE's text positions differ from the
    cache position); the cache slot always comes from `pos`: pos % cap
    under a window, else pos (clamped to the last slot, as the reference's
    dynamic_update_slice clamps). Once a ring buffer wraps every slot is
    inside the window, so the mask counts valid slots only."""
    b = x.shape[0]
    pos = _as_pos(pos, x.device)
    q, k, v = _qkv(p, x, cfg)
    if rope_positions is None:
        lead = (3, b, 1) if cfg.mrope_sections is not None else (b, 1)
        rope_positions = pos.expand(lead)
    q, k = _rotate(q, k, cfg, rope_positions)
    cap = cache.k.shape[1]
    if cfg.sliding_window is not None:
        slot, n_valid = pos % cap, torch.clamp(pos + 1, max=cap)
    else:
        slot, n_valid = torch.clamp(pos, 0, cap - 1), pos + 1
    _fill(cache, k, v, slot.reshape(1))
    out = decode_attention(q, cache.k, cache.v, n_valid)
    return linear(out.reshape(b, 1, -1), p["wo"]), cache


# -- cross-attention (whisper decoder) --------------------------------------------

def cross_attention_train(p, x, enc, cfg: ArchConfig):
    """x: (B, S, D) decoder stream; enc: (B, T_enc, D) encoder output."""
    b, s, _ = x.shape
    t, hd = enc.shape[1], cfg.head_dim
    q = linear(x, p["wq"], p.get("bq")).reshape(b, s, cfg.num_heads, hd)
    k = linear(enc, p["wk"], p.get("bk")).reshape(b, t, cfg.num_kv_heads, hd)
    v = linear(enc, p["wv"], p.get("bv")).reshape(b, t, cfg.num_kv_heads, hd)
    out = chunked_attention(q, k, v, causal=False)
    return linear(out.reshape(b, s, -1), p["wo"])


def cross_attention_train_tp(p, x, enc, cfg: ArchConfig,
                             ms: tp.ModelShards):
    """`cross_attention_train` on the process's model shards, by the
    attention case at T as `attention_train_tp`: in case a each shard its
    column shards of wq and bq on the decoder stream and of wk, wv, bk and
    bv on the encoder's output, which reaches the shards through
    `tp.to_shards` (its backward sums the shards' partial cotangents of
    `enc`); non-causal, no window, no rotation; wo row-parallel."""
    return _attention_tp(p, x, enc, cfg, ms, positions=None, causal=False,
                         window=None)


def cross_attention_cache(p, enc, cfg: ArchConfig) -> AttnCache:
    """The encoder output's keys and values, computed once at prefill."""
    b, t, _ = enc.shape
    hd = cfg.head_dim
    k = linear(enc, p["wk"], p.get("bk")).reshape(b, t, cfg.num_kv_heads, hd)
    v = linear(enc, p["wv"], p.get("bv")).reshape(b, t, cfg.num_kv_heads, hd)
    return AttnCache(k, v)


def cross_attention_decode(p, x, cfg: ArchConfig, cache: AttnCache):
    b = x.shape[0]
    q = linear(x, p["wq"], p.get("bq")).reshape(b, 1, cfg.num_heads,
                                                 cfg.head_dim)
    out = decode_attention(q, cache.k, cache.v, cache.k.shape[1])
    return linear(out.reshape(b, 1, -1), p["wo"])


# -- RWKV6 ("Finch", arXiv:2404.05892): attention-free, data-dependent decay ----

class Rwkv6Cache(NamedTuple):
    state: torch.Tensor  # (B, H, dk, hd) f32 linear-attention state
    x_prev: torch.Tensor  # (B, D) the last token's input (token shift)


DECAY_LORA = 64


def init_rwkv6(gen, cfg: ArchConfig, device, lead: tuple[int, ...] = ()):
    """Token-shift lerp coefficients `mu` (r, k, v, g, w), the five
    projections, the decay's f32 bias `w0` and its low-rank `wA`/`wB`, the
    f32 per-head bonus `u` and group-norm scale `ln_out`."""
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h  # rwkv head size
    p = {"mu": torch.full(lead + (5, d), 0.5, dtype=cfg.dtype, device=device),
         "wr": _normal(gen, lead + (d, d), cfg, d, device),
         "wk": _normal(gen, lead + (d, d), cfg, d, device),
         "wv": _normal(gen, lead + (d, d), cfg, d, device),
         "wg": _normal(gen, lead + (d, d), cfg, d, device),
         "wo": _normal(gen, lead + (d, d), cfg, d, device),
         "w0": torch.full(lead + (d,), -2.0, dtype=_F32, device=device),
         "wA": _normal(gen, lead + (d, DECAY_LORA), cfg, d, device),
         "wB": _normal(gen, lead + (DECAY_LORA, d), cfg, DECAY_LORA,
                       device) * 0.1,
         "u": normal(gen, lead + (h, hd), 0.1, _F32, device),
         "ln_out": torch.ones(lead + (h, hd), dtype=_F32, device=device)}
    return p


def _rwkv6_streams(p, x, x_prev, cfg: ArchConfig):
    """Token-shifted projection streams; x_prev[:, t] = x[:, t - 1]."""
    mu = p["mu"].to(_F32)
    x32, xp32 = x.to(_F32), x_prev.to(_F32)

    def mix(i):
        return (x32 + (xp32 - x32) * mu[i]).to(x.dtype)

    b, s, d = x.shape
    h = cfg.num_heads
    hd = d // h
    r = linear(mix(0), p["wr"]).reshape(b, s, h, hd)
    k = linear(mix(1), p["wk"]).reshape(b, s, h, hd)
    v = linear(mix(2), p["wv"]).reshape(b, s, h, hd)
    g = F.silu(linear(mix(3), p["wg"]))
    lora = torch.tanh(linear(mix(4), p["wA"])).to(_F32)
    # the data-dependent decay, strictly negative
    log_decay = -torch.exp(p["w0"] + lora @ p["wB"].to(_F32))
    return r, k, v, g, log_decay.reshape(b, s, h, hd)


def _rwkv6_out(p, wkv, g):
    """Per-head group norm of wkv (population variance), gate, output
    projection."""
    b, s, h, hd = wkv.shape
    w32 = wkv.to(_F32)
    mean = torch.mean(w32, dim=-1, keepdim=True)
    var = torch.var(w32, dim=-1, keepdim=True, correction=0)
    normed = (w32 - mean) * torch.rsqrt(var + 1e-5) * p["ln_out"]
    y = normed.reshape(b, s, h * hd).to(g.dtype) * g
    return linear(y, p["wo"])


def rwkv6_train(p, x, cfg: ArchConfig):
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, g, ld = _rwkv6_streams(p, x, x_prev, cfg)
    wkv, _ = chunked_linear_attention(r, k, v, ld, bonus=p["u"],
                                      inclusive=False)
    return _rwkv6_out(p, wkv, g)


def rwkv6_train_tp(p, x, cfg: ArchConfig, ms: tp.ModelShards):
    """`rwkv6_train` on the process's model shards (`_rwkv6_tp`)."""
    return _rwkv6_tp(p, x, cfg, ms)[0]


def _rwkv6_tp(p, x, cfg: ArchConfig, ms: tp.ModelShards):
    """(y, each shard's final state of its heads (count, B, H/T, hd, hd)
    f32): `rwkv6_train` on the process's model shards (whole heads a shard:
    H divides by T). The five token-shift mixes are computed once on the
    replicated activations with `mu` put together (`tp.gathered`) and
    handed to the shards (`tp.to_shards`, whose backward sums the
    cotangents before they reach `mu`); wr, wk, wv and wg column-parallel;
    the decay LoRA's f32 partials tanh(mix_w @ wA_j) @ wB_j (wA split on
    its rank axis's columns, wB on its rows) summed over the model axis
    into the whole (tokens, d) pre-activation, handed to the shards
    (`tp.to_shards`), each of which takes its heads' columns and adds its
    slice of w0; the bonus u and the group norm's scale by heads; wo
    row-parallel. The LoRA's narrow products and the chunked linear
    attention run shard by shard: batched, their kernels on the card
    depend on the number of shards, and a shard's bits must not."""
    b, s, d = x.shape
    hd = d // cfg.num_heads
    u = tp.parts(p["u"], -2, "u")  # (count, H/T, hd)
    ln_out = tp.parts(p["ln_out"], -2, "ln_out")
    w0 = tp.parts(p["w0"], -1, "w0")  # (count, D/T)
    mu = tp.gathered(p["mu"], ms).to(_F32)
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    x32, xp32 = x.to(_F32), x_prev.to(_F32)
    mixes = [tp.to_shards((x32 + (xp32 - x32) * mu[i]).to(x.dtype), ms)
             for i in range(5)]
    r, k, v = (linear_col(xs, p[w], None, w)
               for xs, w in zip(mixes, ("wr", "wk", "wv")))
    g = F.silu(linear_col(mixes[3], p["wg"], None, "wg"))
    pre = tp.from_shards(
        [linear(torch.tanh(linear(xi, wa)).to(_F32), wb.to(_F32))
         for xi, wa, wb in zip(mixes[4], tp.parts(p["wA"], -1, "wA"),
                               tp.parts(p["wB"], -2, "wB"))], ms)
    # each shard its heads' columns of the replicated sum (`to_shards`: the
    # backward sums the shards' column cotangents, which every partial
    # needs whole)
    cols = w0.shape[-1]
    wkv, states = [], []
    for i, (y, j) in enumerate(zip(tp.to_shards(pre, ms), ms.shards)):
        log_decay = -torch.exp(y[..., j * cols:(j + 1) * cols] + w0[i])
        heads = [z.reshape(b, s, -1, hd) for z in (r[i], k[i], v[i],
                                                    log_decay)]
        out, state = chunked_linear_attention(*heads, bonus=u[i],
                                              inclusive=False)
        wkv.append(out)
        states.append(state)
    w32 = torch.stack(wkv).to(_F32)  # (count, B, S, H/T, hd)
    mean = torch.mean(w32, dim=-1, keepdim=True)
    var = torch.var(w32, dim=-1, keepdim=True, correction=0)
    normed = (w32 - mean) * torch.rsqrt(var + 1e-5) * ln_out[:, None, None]
    y = normed.reshape(ms.count, b, s, cols).to(g.dtype) * g
    return linear_row(y, p["wo"], ms, "wo"), torch.stack(states)


def rwkv6_prefill(p, x, cfg: ArchConfig):
    """The prompt through the chunked scan; the cache is its final state
    (f32) and the last token's input."""
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, g, ld = _rwkv6_streams(p, x, x_prev, cfg)
    wkv, state = chunked_linear_attention(r, k, v, ld, bonus=p["u"],
                                          inclusive=False)
    return _rwkv6_out(p, wkv, g), Rwkv6Cache(state, x[:, -1])


def rwkv6_decode(p, x, cfg: ArchConfig, cache: Rwkv6Cache):
    """x: (B, 1, D): one recurrent step; the state stays f32, x_prev keeps
    the model's dtype."""
    r, k, v, g, ld = _rwkv6_streams(p, x, cache.x_prev[:, None], cfg)
    out, state = linear_attention_decode(
        r[:, 0], k[:, 0], v[:, 0], ld[:, 0], cache.state.to(_F32),
        bonus=p["u"], inclusive=False)
    y = _rwkv6_out(p, out[:, None], g)
    cache.state.copy_(state)
    cache.x_prev.copy_(x[:, 0])
    return y, cache


# -- Hymba (arXiv:2411.13676): parallel attention and Mamba-2/SSD heads -------

class HymbaCache(NamedTuple):
    attn: AttnCache
    ssm_state: torch.Tensor  # (B, H, N, hd) f32

def init_hymba(gen, cfg: ArchConfig, device, lead: tuple[int, ...] = ()):
    """Attention without its own `wo`, the SSD heads (`wx`, `wbc`, `wdt`,
    the f32 `a_log` and per-head norm `ln`), the shared output projection
    `wo_fused` and the attention heads' f32 norm `ln_attn`."""
    d, h, hd, n = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.ssm_state
    attn = init_attention(gen, cfg, device, lead)
    attn.pop("wo")  # the fused projection replaces the attention-only wo
    ssm = {"a_log": torch.zeros(lead + (h,), dtype=_F32, device=device),
           "ln": torch.ones(lead + (h, hd), dtype=_F32, device=device),
           "wbc": _normal(gen, lead + (d, h * 2 * n), cfg, d, device),
           "wdt": _normal(gen, lead + (d, h), cfg, d, device),
           "wx": _normal(gen, lead + (d, h * hd), cfg, d, device)}
    return {"attn": attn,
            "ln_attn": torch.ones(lead + (h, hd), dtype=_F32, device=device),
            "ssm": ssm,
            "wo_fused": _normal(gen, lead + (h * hd, d), cfg, h * hd, device)}


def _hymba_ssm_streams(p, x, cfg: ArchConfig, proj=None):
    """The SSD heads' streams; `proj(x, p["ssm"], name)` computes the
    projection `name` (by default `linear`; serving by shard puts its
    column chunks together)."""
    proj = proj or (lambda x, sp, name: linear(x, sp[name]))
    b, s, _ = x.shape
    h, hd, n = cfg.num_heads, cfg.head_dim, cfg.ssm_state
    sp = p["ssm"]
    xv = proj(x, sp, "wx").reshape(b, s, h, hd)
    bc = proj(x, sp, "wbc").reshape(b, s, h, 2 * n)
    b_t, c_t = torch.split(bc, n, dim=-1)  # (B, S, H, N) each
    # jax.nn.softplus is logaddexp(x, 0)
    z = proj(x, sp, "wdt").to(_F32)
    dt = torch.logaddexp(z, torch.zeros_like(z))  # (B, S, H)
    log_decay = -torch.exp(sp["a_log"]) * dt  # a scalar decay per head, <= 0
    # SSD discretization: inputs scaled by dt
    xv = (xv.to(_F32) * dt[..., None]).to(x.dtype)
    return c_t, b_t, xv, log_decay


def _headnorm(y, scale):
    y32 = y.to(_F32)
    var = torch.mean(torch.square(y32), dim=-1, keepdim=True)
    return y32 * torch.rsqrt(var + 1e-6) * scale


def _hymba_fused(p, attn_out, ssm_out, x_dtype, b: int, s: int):
    """Mean-fuse the two normalized head groups: (B, S, H * hd)."""
    a = _headnorm(attn_out, p["ln_attn"])
    m = _headnorm(ssm_out, p["ssm"]["ln"])
    return (0.5 * (a + m)).to(x_dtype).reshape(b, s, -1)


def _hymba_fuse(p, attn_out, ssm_out, x_dtype, b: int, s: int):
    """The fused head groups through the shared output projection."""
    return linear(_hymba_fused(p, attn_out, ssm_out, x_dtype, b, s),
                  p["wo_fused"])


def _hymba_heads(p, x, cfg: ArchConfig, positions):
    """Both head groups over the sequence, fused: (B, S, H * hd)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p["attn"], x, cfg)
    q, k = _rotate(q, k, cfg, positions)
    attn_out = chunked_attention(q, k, v, causal=True,
                                 window=cfg.sliding_window)
    c_t, b_t, xv, ld = _hymba_ssm_streams(p, x, cfg)
    ssm_out, _ = chunked_linear_attention(c_t, b_t, xv, ld, inclusive=True)
    return _hymba_fused(p, attn_out, ssm_out, x.dtype, b, s)


def hymba_train(p, x, cfg: ArchConfig, *, positions):
    return linear(_hymba_heads(p, x, cfg, positions), p["wo_fused"])


def hymba_train_tp(p, x, cfg: ArchConfig, ms: tp.ModelShards, *,
                   positions):
    """`hymba_train` on the process's model shards, as attention case c at
    every T (hymba-1.5b's 25 heads divide by no T > 1, and the spec splits
    wx and wbc mid-head and ln, ln_attn on their last axis): every split
    projection and norm put together once (`tp.gathered`), both head
    groups and the fuse computed once on the replicated activations, the
    fused output handed to the shards (`tp.to_shards`, whose backward
    sums the cotangent, so the gathered leaves' gradient is the same on
    every process) and each shard's rows of it through its rows of
    wo_fused (row-parallel)."""
    whole = {"attn": {k: tp.gathered(v, ms) for k, v in p["attn"].items()},
             "ln_attn": tp.gathered(p["ln_attn"], ms),
             "ssm": {k: tp.gathered(v, ms) for k, v in p["ssm"].items()}}
    fused = _hymba_heads(whole, x, cfg, positions)
    rows = fused.shape[-1] // ms.size  # a shard's rows of wo_fused
    return linear_row([f[..., j * rows:(j + 1) * rows] for f, j in
                       zip(tp.to_shards(fused, ms), ms.shards)],
                      p["wo_fused"], ms, "wo_fused")


def hymba_prefill(p, x, cfg: ArchConfig, *, positions, cache_len: int):
    """Both head groups over the prompt. The attention cache is always a
    ring of capacity min(cache_len, window) (window = the config's, else
    cache_len) holding the last tokens at their pos % cap slots; the SSD
    state is the chunked scan's final state (f32)."""
    fused, cache = _hymba_prefill_heads(p, x, cfg, positions, cache_len)
    return linear(fused, p["wo_fused"]), cache


def _hymba_prefill_heads(p, x, cfg: ArchConfig, positions, cache_len: int):
    """`hymba_prefill` up to the fused heads: (B, S, H * hd), cache."""
    b, s, _ = x.shape
    q, k, v = _qkv(p["attn"], x, cfg)
    q, k = _rotate(q, k, cfg, positions)
    attn_out = chunked_attention(q, k, v, causal=True,
                                 window=cfg.sliding_window)
    cap = min(cache_len, cfg.sliding_window or cache_len)
    take = min(s, cap)
    attn = _empty_cache(x, cap, cfg)
    _fill(attn, k[:, s - take:], v[:, s - take:],
          torch.arange(s - take, s, device=x.device) % cap)
    c_t, b_t, xv, ld = _hymba_ssm_streams(p, x, cfg)
    ssm_out, state = chunked_linear_attention(c_t, b_t, xv, ld,
                                              inclusive=True)
    return (_hymba_fused(p, attn_out, ssm_out, x.dtype, b, s),
            HymbaCache(attn, state))


def hymba_decode(p, x, cfg: ArchConfig, cache: HymbaCache, pos):
    """x: (B, 1, D): the token at slot pos % cap, attention over the
    min(pos + 1, cap) valid slots, one SSD step."""
    b = x.shape[0]
    pos = _as_pos(pos, x.device)
    q, k, v = _qkv(p["attn"], x, cfg)
    q, k = _rotate(q, k, cfg, pos.expand(b, 1))
    cap = cache.attn.k.shape[1]
    _fill(cache.attn, k, v, (pos % cap).reshape(1))
    attn_out = decode_attention(q, cache.attn.k, cache.attn.v,
                                torch.clamp(pos + 1, max=cap))
    c_t, b_t, xv, ld = _hymba_ssm_streams(p, x, cfg)
    ssm_out, state = linear_attention_decode(
        c_t[:, 0], b_t[:, 0], xv[:, 0], ld[:, 0],
        cache.ssm_state.to(_F32), inclusive=True)
    y = _hymba_fuse(p, attn_out, ssm_out[:, None], x.dtype, b, 1)
    cache.ssm_state.copy_(state)
    return y, cache


# -- serving over the model axis (`models.tp`) ----------------------------------
#
# The cache lies split as the reference's `cache_specs` lays it
# (`launch.sharding.cache_axes`): where the client ranks share the batch,
# over the T model shards, an attention cache on its slot axis or on
# head_dim, rwkv6's state on its heads or on its key dim and x_prev on
# d_model, hymba's SSD state on head_dim; where they do not (the batch
# whole on every client), the same axes over the client ranks and the
# model shards jointly where they divide, else over the model shards
# alone, else not at all. A cache leaf's parts (`tp.Parts`: the model
# shards, the joint parts, or the whole leaf as one) are what the layers
# below loop over where they touch it; `caches` is the process's parts'
# views of one layer's cache, one cache tuple a part, `split` a leaf's
# `transformer.Split` (its axis in a request row's leaf, the attention's k
# and v (B, C, KH, hd): 1 slots, 3 head_dim; and its parts). The dense
# work is the model shards' (`ms`), once a process. After prefill no
# cache byte crosses a group: a token exchanges q, k and v, the parts'
# partial statistics, the row-parallel partials and rwkv6's token-shift
# and state slices, each gathered over the model group or, for a joint
# leaf, the joint group; every reduction is a sum of the partials in
# shard or part order, so any spread of the mesh gives the one-process
# run's bits.

def _by_shard(what: str, axis) -> ValueError:
    return ValueError(f"serving by shard: {what} split on axis {axis} is not "
                      "a layout the step computes (launch.sharding."
                      "cache_axes)")


def _qkv_whole(p, x, cfg: ArchConfig, ms: tp.ModelShards):
    """q, k and v whole (B, S, H or KH, hd) on every shard (`cols_whole`)."""
    b, s, _ = x.shape
    q, k, v = cols_whole(p, x, ("wq", "wk", "wv"), ms)
    hd = cfg.head_dim
    return (q.reshape(b, s, cfg.num_heads, hd),
            k.reshape(b, s, cfg.num_kv_heads, hd),
            v.reshape(b, s, cfg.num_kv_heads, hd))


def _kv_whole(p, x, cfg: ArchConfig, ms: tp.ModelShards):
    """k and v whole (B, S, KH, hd) on every shard (`cols_whole`)."""
    b, s, _ = x.shape
    return [y.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
            for y in cols_whole(p, x, ("wk", "wv"), ms)]


def _owner_write(leaf, new, local, owned) -> None:
    """new (B, 1, ...) into slot `local` (a 0-d index, in range) of leaf
    (B, C_j, ...) where `owned`, in place; elsewhere the slot keeps its
    bits (no host sync on the position)."""
    idx = local.reshape(1)
    leaf.index_copy_(1, idx, torch.where(owned, new.to(leaf.dtype),
                                         leaf.index_select(1, idx)))


def attend_by_shard(q, k_new, v_new, caches, axis: int, slot, n_valid,
                    parts):
    """One token's attention over a cache split into `parts` (a
    `tp.Parts`, or the `tp.ModelShards` themselves: P parts, those held in
    `parts.shards`), the token's k_new and v_new (B, 1, KH, hd) written
    first (None: none); q (B, 1, H, hd) whole. Returns (B, 1, H, hd) in q's
    dtype, whole. Both layouts keep `decode_attention`'s roundings: q, k,
    v and the normalised probabilities in bf16, f32 sums.

    Slots (axis 1): part j holds slots [j C/P, (j + 1) C/P) of every kv
    head; the token goes only to the part that owns `slot`. Each part's
    f32 row max and sum of exponentials over its valid slots are gathered
    (one exchange) and combined in part order into the whole softmax's
    (`softmax_stats`); each part rounds its slots' normalised
    probabilities to bf16, multiplies them with its values, and the f32
    products are summed in part order. head_dim (axis 3): each part
    writes its slice of the token, the parts' partial f32 scores over
    their slices are summed in part order before the softmax, and each
    part's p.v over its slice is put together. A whole cache is one part
    of its slots."""
    b, _, h, hd = q.shape
    dev = q.device
    # a position on the host (an int): the owner and the valid slots are
    # known here, and no launch is spent finding them
    host = not torch.is_tensor(n_valid)
    if axis == 1:
        n = caches[0].k.shape[1]
        scores, stats = [], []
        for c, j in zip(caches, parts.shards):
            if k_new is not None and host:
                if j * n <= slot < (j + 1) * n:
                    _fill(c, k_new, v_new, torch.full(
                        (1,), slot - j * n, dtype=torch.int64, device=dev))
            elif k_new is not None:
                local = slot - j * n
                owned = (local >= 0) & (local < n)
                local = torch.clamp(local, 0, n - 1)
                _owner_write(c.k, k_new, local, owned)
                _owner_write(c.v, v_new, local, owned)
            if host:
                valid = _valid(min(max(n_valid - j * n, 0), n), n, dev)
            else:
                valid = j * n + torch.arange(n, device=dev) < n_valid
            s, m, l = decode_attention_scores(q, c.k, valid)
            scores.append(s)
            stats.append(torch.stack([m, l], -1))
        every = parts.gather(torch.stack(stats))  # (T, B, KH, rep, 2)
        top, total = softmax_stats(every[..., 0], every[..., 1])
        out = parts.sum(torch.stack([
            decode_attention_values(s, c.v, top, total)
            for s, c in zip(scores, caches)]))
        return out.reshape(b, 1, h, hd).to(q.dtype)
    if axis == 3:
        n, kh = caches[0].k.shape[3], caches[0].k.shape[2]
        scores = []
        for c, j in zip(caches, parts.shards):
            cols = slice(j * n, (j + 1) * n)
            if k_new is not None:
                idx = (torch.full((1,), slot, dtype=torch.int64, device=dev)
                       if host else slot.reshape(1))
                _fill(c, k_new[..., cols], v_new[..., cols], idx)
            qg = _bf16_f32(q[..., cols].reshape(b, kh, h // kh, n))
            scores.append(torch.einsum("bkrd,bckd->bkrc", qg,
                                       _bf16_f32(c.k)))
        s = parts.sum(torch.stack(scores)) / math.sqrt(hd)
        cap = s.shape[-1]
        valid = (_valid(min(n_valid, cap), cap, dev) if host
                 else torch.arange(cap, device=dev) < n_valid)
        if valid is not None:
            s = torch.where(valid, s, -math.inf)
        p = torch.softmax(s, dim=-1)
        out = tp.put_together(torch.stack(
            [torch.einsum("bkrc,bckd->bkrd", _bf16_f32(p),
                          _bf16_f32(c.v)).to(q.dtype) for c in caches]),
            parts, -1)
        return out.reshape(b, 1, h, hd)
    raise _by_shard("an attention cache", axis)


def _valid(count: int, n: int, dev):
    """The mask of the first `count` of n slots; None where all are."""
    if count == n:
        return None
    return torch.arange(n, device=dev) < count


def _slot(cfg: ArchConfig, pos, cap: int, ring: bool = False):
    """(the token's slot, the valid slots) at position `pos` (an int, or a
    0-d tensor) of a cache of `cap` slots (`attention_decode`)."""
    if not torch.is_tensor(pos):
        if ring or cfg.sliding_window is not None:
            return pos % cap, min(pos + 1, cap)
        return min(max(pos, 0), cap - 1), pos + 1
    if ring or cfg.sliding_window is not None:
        return pos % cap, torch.clamp(pos + 1, max=cap)
    return torch.clamp(pos, 0, cap - 1), pos + 1


def _attn_axis(split) -> int:
    """An attention cache's split axis for `attend_by_shard` (a whole
    cache is one part of its slots)."""
    return 1 if split.axis is None else split.axis


def _cap(caches, split) -> int:
    n = caches[0].k.shape[1]
    return n * split.parts.size if _attn_axis(split) == 1 else n


def attention_decode_tp(p, x, cfg: ArchConfig, caches, split, pos,
                        ms: tp.ModelShards, rope_positions=None):
    """`attention_decode` on the process's model shards, the cache's parts
    laid out by `split` (`attend_by_shard`): q, k and v put together,
    rotated whole, the attention by part, wo row-parallel (`row_sum`)."""
    b = x.shape[0]
    q, k, v = _qkv_whole(p, x, cfg, ms)
    if rope_positions is None:
        lead = (3, b, 1) if cfg.mrope_sections is not None else (b, 1)
        rope_positions = _as_pos(pos, x.device).expand(lead)
    q, k = _rotate(q, k, cfg, rope_positions)
    slot, n_valid = _slot(cfg, pos, _cap(caches, split))
    out = attend_by_shard(q, k, v, caches, _attn_axis(split), slot, n_valid,
                          split.parts)
    return row_sum(out.reshape(b, 1, -1), p["wo"], ms, "wo")


def attention_cache_tp(p, x, cfg: ArchConfig, ms: tp.ModelShards, *,
                       positions, cache_len: int) -> AttnCache:
    """The prompt's cache whole (`attention_prefill`'s layout), its k and
    v from the shards' column chunks put together in one exchange."""
    k, v = _kv_whole(p, x, cfg, ms)
    return _prompt_cache(x, _rotate_one(k, cfg, positions), v, cfg,
                         cache_len)


def cross_attention_decode_tp(p, x, cfg: ArchConfig, caches, split,
                              ms: tp.ModelShards):
    """`cross_attention_decode` on the process's model shards: q put
    together, the attention over the cross cache by part (every slot
    valid), wo row-parallel."""
    b = x.shape[0]
    q = cols_whole(p, x, ("wq",), ms)[0].reshape(
        b, 1, cfg.num_heads, cfg.head_dim)
    out = attend_by_shard(q, None, None, caches, _attn_axis(split), None,
                          _cap(caches, split), split.parts)
    return row_sum(out.reshape(b, 1, -1), p["wo"], ms, "wo")


def cross_attention_cache_tp(p, enc, cfg: ArchConfig,
                             ms: tp.ModelShards) -> AttnCache:
    """`cross_attention_cache` whole, from the shards' column chunks."""
    return AttnCache(*_kv_whole(p, enc, cfg, ms))


def rwkv6_prefill_tp(p, x, cfg: ArchConfig, ms: tp.ModelShards,
                     state_axis: int | None):
    """`rwkv6_prefill` on the process's model shards (`rwkv6_train_tp`):
    each shard's final state of its heads kept where the cache splits
    the state over the model shards on its heads (`state_axis` 1 of (B,
    H, dk, dv)), else put together whole (one exchange, at prefill);
    x_prev whole."""
    y, states = _rwkv6_tp(p, x, cfg, ms)
    state = (tp.Sharded(states, -3) if state_axis == 1
             else tp.put_together(states, ms, -3))
    return y, Rwkv6Cache(state, x[:, -1])


def rwkv6_decode_tp(p, x, cfg: ArchConfig, cache, splits,
                    ms: tp.ModelShards):
    """`rwkv6_decode` on the process's model shards; `cache` the layer's
    `Rwkv6Cache` of the held parts' views (state (B, H, dk, dv), x_prev
    (B, D)), `splits` their `transformer.Split`s. Each shard mixes its
    d_model slice of the token shift with its slices of x_prev and `mu`
    (x_prev's parts put together first unless they are the model shards'
    own slices) and the five mixes are put together; each part of x_prev
    keeps its slice of the token; wr, wk, wv, wg column-parallel (a
    shard's columns are its heads); the decay LoRA's f32 partials summed
    in shard order, each shard adding its slice of w0. State split over
    the model shards on its heads: each shard steps its heads as
    `rwkv6_decode` does. Any other layout (split jointly, whose parts'
    heads do not line up with the shards' columns, or on its key dim, or
    whole): r, k, v and the decay put together whole in f32; each part
    reads its heads or its key rows of the state (f32 partials) and steps
    them; the parts' reads are put together (heads) or summed in part
    order (key rows), and each shard adds the bonus term of its own heads.
    Then each shard's heads through the group norm, the gate and its rows
    of wo, summed."""
    st_split, xp_split = splits.state, splits.x_prev
    if xp_split.axis not in (None, 1):
        raise _by_shard("rwkv6's x_prev", xp_split.axis)
    if st_split.axis not in (None, 1, 2):
        raise _by_shard("rwkv6's state", st_split.axis)
    b, _, d = x.shape
    h = cfg.num_heads
    hd = d // h
    mu = tp.parts(p["mu"], -1, "mu").to(_F32)  # (count, 5, D/T)
    n = mu.shape[-1]
    x32 = x.to(_F32)
    xparts = xp_split.parts
    if xparts.level == "model" and xp_split.axis == 1:  # mu's own slices
        xprev = list(cache.x_prev)
    else:
        whole = tp.put_together(torch.stack(cache.x_prev), xparts, -1)
        xprev = [whole[:, j * n:(j + 1) * n] for j in ms.shards]
    mixes = []
    for i, j in enumerate(ms.shards):
        xs, xp = x32[..., j * n:(j + 1) * n], xprev[i][:, None].to(_F32)
        mixes.append(torch.stack([(xs + (xp - xs) * mu[i, t]).to(x.dtype)
                                  for t in range(5)]))
    mixes = tp.put_together(torch.stack(mixes), ms, -1)  # (5, B, 1, D)
    m = cache.x_prev[0].shape[-1]
    for c, j in zip(cache.x_prev, xparts.shards):
        c.copy_(x[:, 0, j * m:(j + 1) * m])
    proj = {w: tp.parts(p[w], -1, w) for w in ("wr", "wk", "wv", "wg")}
    r, k, v = ([linear(mixes[t], proj[w][i]) for i in range(ms.count)]
               for t, w in enumerate(("wr", "wk", "wv")))
    g = [F.silu(linear(mixes[3], proj["wg"][i])) for i in range(ms.count)]
    pre = ms.sum(torch.stack(
        [linear(torch.tanh(linear(mixes[4], wa)).to(_F32), wb.to(_F32))
         for wa, wb in zip(tp.parts(p["wA"], -1, "wA"),
                           tp.parts(p["wB"], -2, "wB"))]))
    w0 = tp.parts(p["w0"], -1, "w0")
    ld = [-torch.exp(pre[..., j * n:(j + 1) * n] + w0[i])
          for i, j in enumerate(ms.shards)]
    u = tp.parts(p["u"], -2, "u")  # (count, H/T, hd)
    hs = u.shape[-2]

    def heads(z):  # (B, 1, H/T * hd) -> (B, H/T, hd)
        return z[:, 0].reshape(b, -1, hd)

    sparts = st_split.parts
    if sparts.level == "model" and st_split.axis == 1:
        out = []
        for i, c in enumerate(cache.state):
            o, state = linear_attention_decode(
                heads(r[i]), heads(k[i]), heads(v[i]), heads(ld[i]),
                c.to(_F32), bonus=u[i], inclusive=False)
            c.copy_(state)
            out.append(o.to(_F32))
    else:
        every = ms.gather(torch.stack([torch.cat(
            [r[i].to(_F32), k[i].to(_F32), v[i].to(_F32), ld[i]], -1)
            for i in range(ms.count)]))  # (T, B, 1, 4 D/T)
        r32, k32, v32, ld32 = (
            torch.cat([e[..., t * n:(t + 1) * n] for e in every.unbind(0)],
                      -1)[:, 0].reshape(b, h, hd) for t in range(4))
        decay = torch.exp(torch.clamp(ld32, -LOG_DECAY_CLAMP, 0.0))
        key_dim = st_split.axis == 2
        size = cache.state[0].shape[2 if key_dim else 1]
        reads = []
        for c, j in zip(cache.state, sparts.shards):
            own = slice(j * size, (j + 1) * size)
            state = c.to(_F32)
            if key_dim:
                reads.append(torch.einsum("bhk,bhkv->bhv", r32[..., own],
                                          state))
                c.copy_(state * decay[..., own, None] + torch.einsum(
                    "bhk,bhv->bhkv", k32[..., own], v32))
            else:
                reads.append(torch.einsum("bhk,bhkv->bhv", r32[:, own],
                                          state))
                c.copy_(state * decay[:, own, :, None] + torch.einsum(
                    "bhk,bhv->bhkv", k32[:, own], v32[:, own]))
        reads = torch.stack(reads)
        whole = (sparts.sum(reads) if key_dim
                 else tp.put_together(reads, sparts, 1))  # (B, H, hd)
        out = []
        for i, j in enumerate(ms.shards):
            own = slice(j * hs, (j + 1) * hs)
            bonus = torch.sum(r32[:, own] * u[i].to(_F32) * k32[:, own],
                              dim=-1, keepdim=True) * v32[:, own]
            out.append((whole[:, own] + bonus).to(r[0].dtype).to(_F32))
    ln_out = tp.parts(p["ln_out"], -2, "ln_out")
    ys = []
    for i in range(ms.count):
        w32 = out[i]
        mean = torch.mean(w32, dim=-1, keepdim=True)
        var = torch.var(w32, dim=-1, keepdim=True, correction=0)
        normed = (w32 - mean) * torch.rsqrt(var + 1e-5) * ln_out[i]
        ys.append(normed.reshape(b, 1, -1).to(g[i].dtype) * g[i])
    wo = tp.parts(p["wo"], -2, "wo")
    return ms.sum(torch.stack([linear(y, w) for y, w in zip(ys, wo)]))


def hymba_prefill_tp(p, x, cfg: ArchConfig, ms: tp.ModelShards, *,
                     positions, cache_len: int):
    """`hymba_prefill` on the process's model shards, as `hymba_train_tp`
    computes (case c): the split projections and norms put together once,
    both head groups and the cache whole, each shard's rows of the fused
    output through its rows of wo_fused."""
    whole = {"attn": {k: tp.gathered(v, ms) for k, v in p["attn"].items()},
             "ln_attn": tp.gathered(p["ln_attn"], ms),
             "ssm": {k: tp.gathered(v, ms) for k, v in p["ssm"].items()}}
    fused, cache = _hymba_prefill_heads(whole, x, cfg, positions, cache_len)
    rows = fused.shape[-1] // ms.size
    return linear_row([fused[..., j * rows:(j + 1) * rows]
                       for j in ms.shards], p["wo_fused"], ms,
                      "wo_fused"), cache


def _hymba_fused_tp(p, attn_out, ssm_out, x_dtype, ms: tp.ModelShards):
    """`_hymba_fused` (B, 1, H * hd) with the norms' scales split over the
    shards: both head groups normalised whole, each shard scaling its
    slice (its heads, or its head_dim columns: the spec's split of `ln`
    and `ln_attn`) and the slices put together."""
    def normed(y):
        y32 = y.to(_F32)
        var = torch.mean(torch.square(y32), dim=-1, keepdim=True)
        return y32 * torch.rsqrt(var + 1e-6)

    a, m = normed(attn_out), normed(ssm_out)
    la, lm = p["ln_attn"], p["ssm"]["ln"]
    b = a.shape[0]
    if not isinstance(la, tp.Sharded):
        la, lm = tp.replicated(la, "ln_attn"), tp.replicated(lm, "ln")
        return (0.5 * (a * la + m * lm)).to(x_dtype).reshape(b, 1, -1)
    ax = la.axis
    sa, sm = tp.parts(la, ax, "ln_attn"), tp.parts(lm, ax, "ln")
    n = sa.shape[ax]
    parts = [(0.5 * (a.narrow(ax, j * n, n) * sa[i]
                     + m.narrow(ax, j * n, n) * sm[i])).to(x_dtype)
             for i, j in enumerate(ms.shards)]
    return tp.put_together(torch.stack(parts), ms, ax).reshape(b, 1, -1)


def hymba_decode_tp(p, x, cfg: ArchConfig, attn_caches, ssm_states,
                    splits, pos, ms: tp.ModelShards):
    """`hymba_decode` on the process's model shards; `attn_caches` the
    held parts of the attention's ring (an `AttnCache` (B, C, KH, hd) a
    part), `ssm_states` those of the SSD state (B, H, N, hd), `splits`
    their `transformer.Split`s. The attention as `attention_decode_tp`
    over its ring; the SSD streams put together from the shards' column
    chunks; each part steps its head_dim slice of the state from its
    slice of the stream (the recurrence is element-wise over head_dim)
    and the parts' outputs are put together; the fuse by shard
    (`_hymba_fused_tp`) and wo_fused row-parallel."""
    kv_split, ssm_split = splits
    if ssm_split.axis not in (None, 3):
        raise _by_shard("hymba's SSD state", ssm_split.axis)
    b = x.shape[0]
    q, k, v = _qkv_whole(p["attn"], x, cfg, ms)
    q, k = _rotate(q, k, cfg, _as_pos(pos, x.device).expand(b, 1))
    slot, n_valid = _slot(cfg, pos, _cap(attn_caches, kv_split), ring=True)
    attn_out = attend_by_shard(q, k, v, attn_caches, _attn_axis(kv_split),
                               slot, n_valid, kv_split.parts)
    c_t, b_t, xv, ld = _hymba_ssm_streams(
        p, x, cfg, lambda z, sp, name: cols_whole(sp, z, (name,), ms)[0])
    n = ssm_states[0].shape[-1]
    outs = []
    for c, j in zip(ssm_states, ssm_split.parts.shards):
        o, state = linear_attention_decode(
            c_t[:, 0], b_t[:, 0], xv[:, 0, :, j * n:(j + 1) * n], ld[:, 0],
            c.to(_F32), inclusive=True)
        c.copy_(state)
        outs.append(o)
    ssm_out = tp.put_together(torch.stack(outs), ssm_split.parts,
                              -1)[:, None]
    fused = _hymba_fused_tp(p, attn_out, ssm_out, x.dtype, ms)
    return row_sum(fused, p["wo_fused"], ms, "wo_fused")
