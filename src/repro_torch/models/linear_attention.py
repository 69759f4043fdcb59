"""Chunked (gated) linear attention, the blocked form of the recurrent
mixers (port of `repro.models.linear_attention`).

One engine serves two families:

- RWKV6 ("Finch"): per-channel data-dependent decay w_t in (0, 1)^dk; the
  output at t reads the state BEFORE the update plus a bonus u on the
  current token (exclusive scores, s < t).
- Mamba-2 / SSD (Hymba's SSM heads): a scalar decay per head; the output
  reads the state AFTER the update (inclusive scores, s <= t).

The sequence is split into chunks of C: within a chunk the interactions are
dense products under a decay-weighted mask, and only the (B, H, dk, dv)
state crosses chunk boundaries. The log-decay is clamped to
[-LOG_DECAY_CLAMP, 0] per step, which changes results (it is part of the
function, kept bit for bit); C = 64 is the reference's blocking, and a
sequence must be a multiple of it (or shorter than one chunk), as there.
The streams are cast to f32 one chunk at a time; the log-decay stays f32.
"""
from __future__ import annotations

import torch

LOG_DECAY_CLAMP = 1.25
CHUNK = 64

_F32 = torch.float32


def chunked_linear_attention(r, k, v, log_decay, *, bonus=None,
                             inclusive: bool, initial_state=None,
                             chunk: int = CHUNK):
    """r, k: (B, S, H, dk); v: (B, S, H, dv).

    log_decay: (B, S, H, dk) per channel (RWKV6) or (B, S, H) scalar (SSD);
    values <= 0. bonus: (H, dk), RWKV6's u on the current token.
    inclusive: scores include s == t (SSD) or not (RWKV6).
    Returns (out (B, S, H, dv) in r's dtype, final_state (B, H, dk, dv) f32).
    """
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    if log_decay.dim() == 3:
        log_decay = log_decay[..., None]  # a channel dim of size 1
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"seq {s} must divide chunk {c}")
    lw = torch.clamp(log_decay.to(_F32), -LOG_DECAY_CLAMP, 0.0)
    state = (torch.zeros((b, h, dk, dv), dtype=_F32, device=r.device)
             if initial_state is None else initial_state)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      0 if inclusive else -1)
    u = None if bonus is None else bonus.to(_F32)
    outs = []
    for i in range(s // c):
        sl = slice(i * c, (i + 1) * c)
        rc, kc, vc = r[:, sl].to(_F32), k[:, sl].to(_F32), v[:, sl].to(_F32)
        lwc = lw[:, sl]
        la = torch.cumsum(lwc, dim=1)  # inclusive cumulative log decay
        la_q = la if inclusive else la - lwc  # exclusive for rwkv
        r_t = rc * torch.exp(la_q)  # decayed queries
        k_t = kc * torch.exp(-la)  # inverse-decayed keys (the clamp bounds it)
        o_inter = torch.einsum("bchk,bhkv->bchv", r_t, state)
        scores = torch.einsum("bqhk,bshk->bhqs", r_t, k_t)
        scores = torch.where(mask, scores, 0.0)
        o_intra = torch.einsum("bhqs,bshv->bqhv", scores, vc)
        if u is not None:
            diag = torch.einsum("bchk,hk,bchk->bch", rc, u, kc)
            o_intra = o_intra + diag[..., None] * vc
        # S' = exp(la_C) . S + sum_s exp(la_C - la_s) k_s v_s^T
        la_end = la[:, -1:]
        k_carry = kc * torch.exp(la_end - la)
        state = state * torch.exp(la_end[:, 0])[..., None] + torch.einsum(
            "bshk,bshv->bhkv", k_carry, vc)
        outs.append(o_inter + o_intra)
    out = torch.cat(outs, dim=1).reshape(b, s, h, dv)
    return out.to(r.dtype), state


def linear_attention_decode(r, k, v, log_decay, state, *, bonus=None,
                            inclusive: bool):
    """One recurrent step. r, k: (B, H, dk); v: (B, H, dv); log_decay
    (B, H, dk) or (B, H); state (B, H, dk, dv). Returns (out (B, H, dv),
    new_state)."""
    r32, k32, v32 = (t.to(_F32) for t in (r, k, v))
    ld = torch.clamp(log_decay.to(_F32), -LOG_DECAY_CLAMP, 0.0)
    if ld.dim() == 2:
        ld = ld[..., None]
    w = torch.exp(ld)
    kv = torch.einsum("bhk,bhv->bhkv", k32, v32)
    if inclusive:
        new_state = state * w[..., None] + kv
        out = torch.einsum("bhk,bhkv->bhv", r32, new_state)
    else:
        read = state + (bonus.to(_F32)[None, :, :, None] * kv
                        if bonus is not None else kv * 0.0)
        out = torch.einsum("bhk,bhkv->bhv", r32, read)
        new_state = state * w[..., None] + kv
    return out.to(r.dtype), new_state


def reference_linear_attention(r, k, v, log_decay, *, bonus=None,
                               inclusive: bool, initial_state=None):
    """The O(T) sequential oracle: one `linear_attention_decode` step per
    token. Returns (out (B, S, H, dv), final_state)."""
    b, s, h, dk = r.shape
    state = (torch.zeros((b, h, dk, v.shape[-1]), dtype=_F32, device=r.device)
             if initial_state is None else initial_state)
    outs = []
    for t in range(s):
        out, state = linear_attention_decode(
            r[:, t], k[:, t], v[:, t], log_decay[:, t], state, bonus=bonus,
            inclusive=inclusive)
        outs.append(out)
    return torch.stack(outs, dim=1), state
