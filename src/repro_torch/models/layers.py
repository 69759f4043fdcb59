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


def mlp(x, p, act: str):
    if act == "swiglu":
        return linear(F.silu(linear(x, p["w_gate"])) * linear(x, p["w_up"]),
                      p["w_down"])
    if act == "relu2":  # RWKV channel mix: relu(xW)^2
        return linear(torch.square(F.relu(linear(x, p["w_up"]))), p["w_down"])
    h = gelu(linear(x, p["w_up"], p.get("b_up")))
    return linear(h, p["w_down"], p.get("b_down"))


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
