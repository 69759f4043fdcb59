"""Shared layers of every model family (port of `repro.models.layers`).

Conventions as in the reference: activations (B, S, D), attention heads
(B, S, H, hd), parameters plain dicts of tensors; norms and softmax work in
f32 whatever the activation dtype. Plain PyTorch throughout: no kernel of
the reference lives here (the reference's `decode_attention` is plain
`jnp` as well).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import tp

_F32 = torch.float32


# -- norms ---------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    x32 = x.to(_F32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x, scale, bias=None, eps: float = 1e-6):
    """The reference's LayerNorm: normalise in f32 with eps 1e-6, cast back
    to the activation dtype, then scale and shift (not F.layer_norm's
    order or eps)."""
    x32 = x.to(_F32)
    mean = torch.mean(x32, dim=-1, keepdim=True)
    centered = x32 - mean
    var = torch.mean(torch.square(centered), dim=-1, keepdim=True)
    out = (centered * torch.rsqrt(var + eps)).to(x.dtype) * scale
    if bias is not None:
        out = out + bias
    return out


def norm(x, params, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params.get("bias"))


def init_norm(d: int, kind: str, dtype, device, lead: tuple[int, ...] = ()):
    p = {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
    return p


# -- rotary embeddings ---------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=_F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(_F32) * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(_F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float, sections: tuple[int, int, int]):
    """Multimodal RoPE (qwen2-vl, arXiv:2409.12191). positions3: (3, B, S)
    temporal / height / width ids. The head_dim/2 frequency channels are
    split into three sections, each rotated by its own position stream."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    sec = torch.tensor(sum(([i] * n for i, n in enumerate(sections)), []),
                       dtype=torch.int64, device=x.device)
    # the channel's stream: (hd/2, B, S) -> (B, S, hd/2)
    pos = torch.movedim(positions3[sec], 0, -1).to(_F32)
    angles = pos * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(_F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- attention -------------------------------------------------------------------

def _gqa_expand(k, n_rep: int):
    """(B, S, KH, hd) -> (B, S, KH * n_rep, hd) by repetition."""
    if n_rep == 1:
        return k
    b, s, kh, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, hd).reshape(
        b, s, kh * n_rep, hd)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None, q_offset: int = 0,
                      block: int = 1024):
    """Streaming-softmax attention with the reference's semantics
    (`chunked_attention`): q and kv in blocks of `block`, fully masked kv
    blocks skipped, f32 scores and statistics, and the probabilities and
    values rounded to bf16 before their product, which accumulates in f32.

    q: (B, Sq, H, hd); k, v: (B, Skv, KH, hd), H % KH == 0.
    Returns (B, Sq, H, hd) in q's dtype.
    """
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    k = _gqa_expand(k, h // kh)
    v = _gqa_expand(v, h // kh)
    scale = 1.0 / math.sqrt(hd)
    block = min(block, skv)
    nblk = -(-skv // block)
    pad = nblk * block - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kb = k.reshape(b, nblk, block, h, hd)
    vb = v.reshape(b, nblk, block, h, hd)
    qb_size = min(block, sq)
    nqb = -(-sq // qb_size)
    q32 = q.to(_F32) * scale
    if nqb * qb_size > sq:
        q32 = F.pad(q32, (0, 0, 0, 0, 0, nqb * qb_size - sq))
    dev = q.device
    outs = []
    for qi in range(nqb):
        q_blk = q32[:, qi * qb_size:(qi + 1) * qb_size]
        q_pos = q_offset + qi * qb_size + torch.arange(qb_size, device=dev)
        q_lo = q_offset + qi * qb_size
        q_hi = q_offset + min((qi + 1) * qb_size, sq) - 1
        j_lo = 0 if window is None else max(0, (q_lo - window + 1) // block)
        j_hi = min(nblk - 1, q_hi // block) if causal else nblk - 1
        j_hi = max(j_hi, j_lo)
        m = torch.full((b, h, qb_size), -math.inf, dtype=_F32, device=dev)
        l = torch.zeros((b, h, qb_size), dtype=_F32, device=dev)
        acc = torch.zeros((b, h, qb_size, hd), dtype=_F32, device=dev)
        for j in range(j_lo, j_hi + 1):
            kv_pos = j * block + torch.arange(block, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk, kb[:, j].to(_F32))
            mask = torch.ones((qb_size, block), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, None] >= kv_pos[None, :]
            if window is not None:
                mask &= q_pos[:, None] - kv_pos[None, :] < window
            mask &= (kv_pos < skv)[None, :]
            s = torch.where(mask, s, -math.inf)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                         -math.inf))
            l = l * corr + torch.sum(p, dim=-1)
            # probabilities and values meet in bf16, the sum stays f32
            pv = torch.einsum("bhqk,bkhd->bhqd",
                              p.to(torch.bfloat16).to(_F32),
                              vb[:, j].to(torch.bfloat16).to(_F32))
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=2)[:, :, :sq]
    return out.transpose(1, 2).to(q.dtype)


def _bf16_f32(x):
    """x rounded to bf16 and widened back: a product of two such values is
    exact in f32, so an f32 product of them is a bf16 product that
    accumulates in f32 (the reference's `preferred_element_type`)."""
    return x.to(torch.bfloat16).to(_F32)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: int | None = None):
    """Single-token attention against a (possibly ring-buffered) KV cache,
    with the reference's semantics (`decode_attention`).

    q: (B, 1, H, hd); caches: (B, C, KH, hd); cache_len: the number of
    valid slots, an int or a 0-d integer tensor (slots >= cache_len are
    masked; a wrapped ring buffer has every slot valid). GQA groups q as
    (B, KH, rep, hd) instead of broadcasting the cache to H heads. q, k and
    v meet in bf16 with f32 sums; the scores are divided by sqrt(hd) after
    the product, the softmax is f32 and its probabilities are rounded to
    bf16 before the second product. Returns (B, 1, H, hd) in q's dtype.
    """
    b, _, h, hd = q.shape
    c, kh = k_cache.shape[1], k_cache.shape[2]
    qg = _bf16_f32(q.reshape(b, kh, h // kh, hd))
    s = torch.einsum("bkrd,bckd->bkrc", qg, _bf16_f32(k_cache))
    s = s / math.sqrt(hd)
    pos = torch.arange(c, device=q.device)
    valid = pos < cache_len
    if window is not None:
        valid &= pos >= cache_len - window
    s = torch.where(valid, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrc,bckd->bkrd", _bf16_f32(p), _bf16_f32(v_cache))
    return out.reshape(b, 1, h, hd).to(q.dtype)


# -- dense projections / FFN -------------------------------------------------------

def linear(x, w, b=None):
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def gelu(x):
    """jax.nn.gelu's default: the tanh approximation, not torch's erf form."""
    return F.gelu(x, approximate="tanh")


def mlp(x, p, act: str, ms: tp.ModelShards | None = None):
    """The FFN; with `ms`, on the process's d_ff shards (`mlp_tp`)."""
    if ms is not None:
        return mlp_tp(x, p, act, ms)
    if act == "swiglu":
        return linear(F.silu(linear(x, p["w_gate"])) * linear(x, p["w_up"]),
                      p["w_down"])
    if act == "relu2":  # RWKV channel mix: relu(xW)^2
        return linear(torch.square(F.relu(linear(x, p["w_up"]))), p["w_down"])
    h = gelu(linear(x, p["w_up"], p.get("b_up")))
    return linear(h, p["w_down"], p.get("b_down"))


# -- over the model axis (`models.tp`): the process's shards -----------------------

def _bmm(xs, ws):
    """(count, ..., K) @ (count, K, N) -> (count, ..., N): one batched
    matmul, shard i's slice the product of its own operands."""
    c, k = xs.shape[0], xs.shape[-1]
    y = torch.bmm(xs.reshape(c, -1, k), ws)
    return y.reshape(*xs.shape[:-1], ws.shape[-1])


def linear_col(xs, w, b=None, name: str = "w") -> torch.Tensor:
    """Column-parallel projection: each shard's input (`to_shards`,
    (count, ..., D)) times its column shard of `w` (and plus its shard of
    the bias): the shards' outputs, (count, ..., F/T)."""
    y = _bmm(xs, tp.parts(w, -1, name))
    if b is not None:
        bs = tp.parts(b, -1, "b" + name[1:])
        y = y + bs.reshape(bs.shape[0], *([1] * (y.dim() - 2)), -1)
    return y


def linear_row(hs, w, ms: tp.ModelShards, name: str = "w") -> torch.Tensor:
    """Row-parallel projection: each shard's input ((count, ..., F/T), or
    a sequence of them) times its row shard of `w`, the partials summed
    over the model axis (`from_shards`)."""
    if not torch.is_tensor(hs):
        hs = torch.stack(tuple(hs))
    return tp.from_shards(_bmm(hs, tp.parts(w, -2, name)), ms)


def mlp_partials(xs, p, act: str) -> torch.Tensor:
    """Each shard's partial FFN output, (count, ..., D): its d_ff shard of
    the up (and gate) projection, the activation, its rows of the down
    projection; the caller sums them (with anything else it adds per
    shard)."""
    up = linear_col(xs, p["w_up"], p.get("b_up"), "w_up")
    if act == "swiglu":
        h = F.silu(linear_col(xs, p["w_gate"], None, "w_gate")) * up
    elif act == "relu2":
        h = torch.square(F.relu(up))
    else:
        h = gelu(up)
    return _bmm(h, tp.parts(p["w_down"], -2, "w_down"))


def mlp_tp(x, p, act: str, ms: tp.ModelShards):
    """`mlp` over the model axis: the partials of the process's d_ff
    shards summed over the model axis, then the (whole) down bias."""
    y = tp.from_shards(mlp_partials(tp.to_shards(x, ms), p, act), ms)
    if p.get("b_down") is not None:
        y = y + tp.replicated(p["b_down"], "b_down")
    return y


def embed_tokens_tp(tokens, table, ms: tp.ModelShards):
    """The vocab-parallel lookup: each shard looks up the ids among its
    rows of the table, zeros elsewhere, and the shards are summed. One
    shard holds each id and the rest add zeros, so it is the whole
    lookup's bits."""
    parts = tp.parts(table, -2, "embed")
    rows = parts[0].shape[0]
    outs = []
    for w, j in zip(parts, ms.shards):
        local = tokens - j * rows
        hit = (local >= 0) & (local < rows)
        e = w[torch.clamp(local, 0, rows - 1)]
        outs.append(torch.where(hit[..., None], e, 0))
    return tp.from_shards(outs, ms)


def vocab_parallel_nll(x, table, labels, true_vocab: int,
                       ms: tp.ModelShards):
    """Per-token CE in f32 over the vocab-parallel head: each shard's
    logits x @ table_shard^T with the pad ids (global id >= true_vocab)
    masked to -1e30; the max over the shards (exact, no gradient), then
    the sum of exp(logit - max) and the gold logit, each a per-token
    scalar a shard summed over the model axis in shard order."""
    xs = tp.to_shards(x, ms)
    parts = tp.parts(table, -2, "lm_head")
    rows = parts[0].shape[0]
    l32s, maxes = [], []
    for xi, w, j in zip(xs, parts, ms.shards):
        l32 = torch.matmul(xi, w.t()).to(_F32)
        if (j + 1) * rows > true_vocab:
            pad = torch.arange(j * rows, (j + 1) * rows,
                               device=x.device) >= true_vocab
            l32 = l32.masked_fill(pad, -1e30)
        l32s.append(l32)
        maxes.append(torch.amax(l32.detach(), dim=-1))
    m = torch.amax(ms.gather(torch.stack(maxes)), dim=0)
    sums, golds = [], []
    for l32, j in zip(l32s, ms.shards):
        sums.append(torch.sum(torch.exp(l32 - m[..., None]), dim=-1))
        local = labels.to(torch.int64) - j * rows
        hit = (local >= 0) & (local < rows)
        g = torch.gather(l32, -1, torch.clamp(local, 0, rows - 1)[..., None])
        golds.append(torch.where(hit, g[..., 0], 0.0))
    logz = m + torch.log(tp.from_shards(sums, ms))
    return logz - tp.from_shards(golds, ms)


# -- serving over the model axis: one shard's own call at a time -----------------
#
# A decode step's GEMMs are a few rows wide: on the card a batched op's
# slice is not always the bits of its own call at such shapes, so each
# shard's part is its own call, the same one whatever number of shards
# the process holds, and the parts meet only in `tp`'s gathers and
# shard-order sums.

def cols_whole(p, x, names, ms: tp.ModelShards) -> list:
    """x @ p[w] (+ its bias p["b" + w[1:]]) whole on every shard for each
    projection w of `names`: each shard's column chunks (its own matmuls)
    of the split ones put together in one exchange; a leaf the spec left
    whole computed directly."""
    out, parts, widths = {}, [], []
    for w in names:
        bias = p.get("b" + w[1:])
        if not isinstance(p[w], tp.Sharded):
            out[w] = linear(x, p[w], tp.replicated(bias, "b" + w[1:]))
            continue
        ws = tp.parts(p[w], -1, w)
        bs = None if bias is None else tp.parts(bias, -1, "b" + w[1:])
        parts.append([linear(x, ws[i], None if bs is None else bs[i])
                      for i in range(ms.count)])
        widths.append((w, ws.shape[-1]))
    if parts:
        every = ms.gather(torch.stack([torch.cat(chunks, dim=-1)
                                       for chunks in zip(*parts)]))
        lo = 0
        for w, n in widths:
            out[w] = torch.cat([e.narrow(-1, lo, n) for e in every.unbind(0)],
                               dim=-1)
            lo += n
    return [out[w] for w in names]


def row_sum(h, w, ms: tp.ModelShards, name: str = "w"):
    """h @ w for h (..., F) whole on every shard: each shard its rows of
    w times its slice of h's last axis, the partials summed over the
    model axis in shard order; a whole leaf computed directly."""
    if not isinstance(w, tp.Sharded):
        return linear(h, w)
    ws = tp.parts(w, -2, name)
    n = ws.shape[-2]
    return ms.sum(torch.stack([linear(h[..., j * n:(j + 1) * n], ws[i])
                               for i, j in enumerate(ms.shards)]))


def mlp_by_shard(x, p, act: str, ms: tp.ModelShards):
    """`mlp` over the model axis for a few rows: each shard's d_ff slice of
    the FFN its own calls, the partials summed in shard order, then the
    (whole) down bias."""
    up = tp.parts(p["w_up"], -1, "w_up")
    b_up = p.get("b_up")
    b_up = None if b_up is None else tp.parts(b_up, -1, "b_up")
    gate = (tp.parts(p["w_gate"], -1, "w_gate") if act == "swiglu"
            else None)
    down = tp.parts(p["w_down"], -2, "w_down")
    parts = []
    for i in range(ms.count):
        u = linear(x, up[i], None if b_up is None else b_up[i])
        if act == "swiglu":
            h = F.silu(linear(x, gate[i])) * u
        elif act == "relu2":
            h = torch.square(F.relu(u))
        else:
            h = gelu(u)
        parts.append(linear(h, down[i]))
    y = ms.sum(torch.stack(parts))
    if p.get("b_down") is not None:
        y = y + tp.replicated(p["b_down"], "b_down")
    return y


def vocab_logits(x, table, true_vocab: int, ms: tp.ModelShards):
    """`lm_logits` over the vocab-parallel head: each shard's logits
    against its rows of the table (its own matmul), the pad ids (global
    id >= true_vocab) masked to -1e30, put together over the model group;
    a whole table computed directly."""
    if not isinstance(table, tp.Sharded):
        return lm_logits(x, table, true_vocab)
    parts = tp.parts(table, -2, "lm_head")
    rows = parts.shape[-2]
    outs = []
    for w, j in zip(parts, ms.shards):
        logits = torch.matmul(x, w.t())
        if (j + 1) * rows > true_vocab:
            pad = torch.arange(j * rows, (j + 1) * rows,
                               device=x.device) >= true_vocab
            logits = logits.masked_fill(pad, -1e30)
        outs.append(logits)
    return tp.put_together(torch.stack(outs), ms, -1)


def decode_attention_scores(q, k, valid):
    """One shard's scores in `decode_attention` over the slots it holds: q
    (B, 1, H, hd) whole, k (B, C_j, KH, hd) its slots, `valid` (C_j,)
    which of them hold tokens (None: all). q and k meet in bf16 with f32 sums and the
    product is divided by sqrt(hd): (s (B, KH, rep, C_j), its masked f32
    row max m (-inf where no slot is valid), the sum l of exp(s - m))."""
    b, _, h, hd = q.shape
    kh = k.shape[2]
    qg = _bf16_f32(q.reshape(b, kh, h // kh, hd))
    s = torch.einsum("bkrd,bckd->bkrc", qg, _bf16_f32(k)) / math.sqrt(hd)
    if valid is None:  # every slot valid: m is finite
        m = torch.amax(s, dim=-1)
        return s, m, torch.sum(torch.exp(s - m[..., None]), dim=-1)
    s = torch.where(valid, s, -math.inf)
    m = torch.amax(s, dim=-1)
    l = torch.sum(torch.exp(s - torch.where(torch.isfinite(m), m,
                                            0.0)[..., None]), dim=-1)
    return s, m, l


def softmax_stats(m, l):
    """The T shards' row maxes and sums (T, ...), in shard order, as the
    whole softmax's: (the max over the shards, each shard's sum rescaled
    by exp(m_j - max) and added in shard order 0..T-1)."""
    top = torch.amax(m, dim=0)
    total = l[0] * torch.exp(m[0] - top)  # 0 for a shard with no valid slot
    for j in range(1, m.shape[0]):
        total = total + l[j] * torch.exp(m[j] - top)
    return top, total


def decode_attention_values(s, v, top, total):
    """One shard's part of the output: its slots' probabilities exp(s -
    max) / sum, normalised by the whole softmax's statistics and rounded
    to bf16 (`decode_attention`'s probabilities), times its values in
    bf16 with f32 sums: (B, KH, rep, hd) f32, summed over the shards by
    the caller."""
    p = torch.exp(s - top[..., None]) / total[..., None]
    return torch.einsum("bkrc,bckd->bkrd", _bf16_f32(p), _bf16_f32(v))


def normal(gen, shape, scale, dtype, device):
    """A draw of N(0, scale^2) in `dtype` (shapes only on 'meta')."""
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device) * scale


def init_mlp(gen, d: int, f: int, act: str, dtype, device,
             lead: tuple[int, ...] = ()):
    """w_down, w_up (and w_gate for swiglu), scaled by 1/sqrt(fan_in), with
    the leading dims `lead` (the stacked layer axis)."""
    p = {"w_down": normal(gen, lead + (f, d), f ** -0.5, dtype, device)}
    if act == "swiglu":
        p["w_gate"] = normal(gen, lead + (d, f), d ** -0.5, dtype, device)
    p["w_up"] = normal(gen, lead + (d, f), d ** -0.5, dtype, device)
    return p


def embed_tokens(tokens, table):
    return table[tokens]


def lm_logits(x, table, true_vocab: int):
    """Project to the (padded) vocab and mask pad ids to -1e30."""
    logits = torch.matmul(x, table.t())
    v_pad = table.shape[0]
    if v_pad > true_vocab:
        pad = torch.arange(v_pad, device=x.device) >= true_vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def token_nll(logits, labels, true_vocab: int):
    """Per-token CE in f32; masks the padded vocab tail itself."""
    logits = logits.to(_F32)
    v_pad = logits.shape[-1]
    if v_pad > true_vocab:
        pad = torch.arange(v_pad, device=logits.device) >= true_vocab
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return logz - gold


def cross_entropy(logits, labels, true_vocab: int):
    """Mean CE in f32; masks the padded vocab tail itself."""
    return torch.mean(token_nll(logits, labels, true_vocab))
