"""Mixture-of-Experts FFN, capacity-free (dropless) top-k routing (port of
`repro.models.moe`).

The reference's dispatch, step for step:

  1. router logits in f32 -> softmax -> top-k experts and their weights,
     renormalised to sum to one per token;
  2. per batch row, each token copied k times and the copies sorted by
     expert id (a stable sort, as `jnp.argsort`);
  3. the grouped FFN: each expert's contiguous segment of sorted copies
     through that expert's matrices (the reference's
     `lax.ragged_dot_general`, an XLA op and not a Pallas kernel: here one
     `torch.matmul` per non-empty segment), so only active experts work;
  4. unsort, and the weighted sum over the k copies.

Qwen2-MoE's shared experts are one dense FFN of width `shared_expert_ff`
added for every token. `moe_ffn_ref` is the dense oracle (every expert on
every token, a masked sum), kept for the tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import census
from repro_torch.models import tp
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    gelu,
    init_mlp,
    linear,
    mlp,
    mlp_partials,
    normal,
)

_F32 = torch.float32


def expert_counts(flat_e: torch.Tensor, num_experts: int) -> list:
    """(B, E) host ints: each row of `flat_e` (B, n) expert ids, its
    count of copies routed to each expert; one `.tolist()`, a device
    sync, per call. Under the dry run's census (`kernels.census.active`),
    whose fake tensors hold no values to count, each row's n copies split
    as evenly as they go, the first n mod E experts one more: the grouped
    FFN runs the same ops, one matmul a non-empty segment; only the
    segments' sizes are not the data's."""
    if census.active() is not None:
        b, n = flat_e.shape
        q, r = divmod(n, num_experts)
        return [[q + (j < r) for j in range(num_experts)] for _ in range(b)]
    # analysis: allow[trace-hazard] the grouped FFN's segment sizes are host
    # ints (one matmul a segment); blocks CUDA-graph capture (ROADMAP parked)
    return torch.stack([torch.bincount(row, minlength=num_experts)
                        for row in flat_e]).tolist()


def init_moe(gen, cfg: ArchConfig, device, lead: tuple[int, ...] = ()):
    """router (f32), w_down, w_gate, w_up (one matrix per expert), and the
    shared expert's MLP, with the leading dims `lead`."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": normal(gen, lead + (d, e), d ** -0.5, _F32, device),
         "w_down": normal(gen, lead + (e, f, d), f ** -0.5, cfg.dtype, device),
         "w_gate": normal(gen, lead + (e, d, f), d ** -0.5, cfg.dtype, device),
         "w_up": normal(gen, lead + (e, d, f), d ** -0.5, cfg.dtype, device)}
    if cfg.shared_expert_ff:
        p["shared"] = init_mlp(gen, d, cfg.shared_expert_ff, cfg.act,
                               cfg.dtype, device, lead)
    return p


def _route(p, x, cfg: ArchConfig):
    """(probs (B, S, E), top_w (B, S, K), top_e (B, S, K)) in f32. Ties go
    to the lower expert index, as `lax.top_k`: a stable descending sort."""
    logits = linear(x.to(_F32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    top_w, top_e = top_w[..., :k], top_e[..., :k]
    top_w = top_w / torch.clamp(torch.sum(top_w, -1, keepdim=True), min=1e-9)
    return probs, top_w, top_e


def _grouped(lhs, rhs, counts):
    """lhs (B, T, K) sorted by expert within each row, rhs (E, K, N),
    counts (B, E) host ints -> (B, T, N): each (row, expert) segment times
    that expert's matrix. One unbind of rhs, so the backward pass stacks
    the experts' gradients once."""
    b, t, _ = lhs.shape
    experts = rhs.unbind(0)
    sizes = [c for row in counts for c in row]
    parts = torch.split(lhs.reshape(b * t, -1), sizes)
    e = len(experts)
    out = [torch.matmul(seg, experts[j % e])
           for j, seg in enumerate(parts) if sizes[j]]
    return torch.cat(out).reshape(b, t, -1)


def moe_ffn(p, x, cfg: ArchConfig, *, return_aux: bool = False):
    """x: (B, S, D) -> (B, S, D); S == 1 (decode) runs unchanged.

    The grouped FFN reads the per-row expert counts on the host
    (`expert_counts`: one `.tolist()`, a device sync, per call). With
    return_aux, also the Switch-style load-balance diagnostic E *
    sum_e(frac_e * mean_p_e): the fraction of token copies routed to each
    expert against its mean router probability, (y, aux) with aux a 0-d
    f32 tensor."""
    b, s, d = x.shape
    k = cfg.experts_per_token
    probs, top_w, top_e = _route(p, x, cfg)
    flat_e = top_e.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # per-row local sort
    inv = torch.argsort(order, dim=-1, stable=True)
    xk = torch.repeat_interleave(x, k, dim=1)  # (B, S*K, D) token copies
    xs = torch.gather(xk, 1, order[..., None].expand(b, s * k, d))
    counts = expert_counts(flat_e, cfg.num_experts)
    if cfg.act == "swiglu":
        h = (F.silu(_grouped(xs, p["w_gate"], counts))
             * _grouped(xs, p["w_up"], counts))
    else:
        h = gelu(_grouped(xs, p["w_up"], counts))
    ys = _grouped(h, p["w_down"], counts)  # (B, S*K, D)
    yk = torch.gather(ys, 1, inv[..., None].expand(b, s * k, d))
    y = torch.sum(yk.reshape(b, s, k, d) * top_w[..., None].to(yk.dtype),
                  dim=2)
    if cfg.shared_expert_ff:
        y = y + mlp(x, p["shared"], cfg.act)
    if return_aux:
        e = cfg.num_experts
        frac = torch.mean(F.one_hot(top_e, e).to(_F32), dim=(0, 1, 2))
        mean_p = torch.mean(probs, dim=(0, 1))
        return y, e * torch.sum(frac * mean_p)
    return y


def moe_ffn_tp(p, x, cfg: ArchConfig, ms: tp.ModelShards):
    """`moe_ffn` on the process's model shards: the routing (the router
    whole) on the replicated activations, the same experts and counts on
    every shard; each shard runs the grouped FFN on its d_ff shard of every
    expert (w_gate and w_up on their last axis, w_down on axis -2) and
    combines its copies with the routing weights, adds its partial of the
    shared expert, and the shards' partials are summed over the model
    axis; then the shared expert's (whole) down bias, as `mlp_tp` adds
    it."""
    b, s, d = x.shape
    k = cfg.experts_per_token
    p = dict(p, router=tp.replicated(p["router"], "router"))
    _, top_w, top_e = _route(p, x, cfg)
    flat_e = top_e.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    inv = torch.argsort(order, dim=-1, stable=True)
    counts = expert_counts(flat_e, cfg.num_experts)
    xs = tp.to_shards(x, ms)
    ws = tp.to_shards(top_w, ms)
    up = tp.parts(p["w_up"], -1, "w_up")
    gate = (tp.parts(p["w_gate"], -1, "w_gate") if cfg.act == "swiglu"
            else up)
    down = tp.parts(p["w_down"], -2, "w_down")
    shared = (mlp_partials(xs, p["shared"], cfg.act) if cfg.shared_expert_ff
              else None)
    partials = []
    for i in range(ms.count):
        xk = torch.repeat_interleave(xs[i], k, dim=1)
        xsrt = torch.gather(xk, 1, order[..., None].expand(b, s * k, d))
        if cfg.act == "swiglu":
            h = (F.silu(_grouped(xsrt, gate[i], counts))
                 * _grouped(xsrt, up[i], counts))
        else:
            h = gelu(_grouped(xsrt, up[i], counts))
        ys = _grouped(h, down[i], counts)
        yk = torch.gather(ys, 1, inv[..., None].expand(b, s * k, d))
        y = torch.sum(yk.reshape(b, s, k, d)
                      * ws[i][..., None].to(yk.dtype), dim=2)
        if shared is not None:
            y = y + shared[i]
        partials.append(y)
    y = tp.from_shards(partials, ms)
    if shared is not None and p["shared"].get("b_down") is not None:
        y = y + tp.replicated(p["shared"]["b_down"], "shared.b_down")
    return y


def moe_ffn_ref(p, x, cfg: ArchConfig):
    """The dense oracle: every expert on every token, combined by the
    routing weights (zero for the experts a token did not pick)."""
    _, top_w, top_e = _route(p, x, cfg)
    comb = torch.sum(F.one_hot(top_e, cfg.num_experts).to(_F32)
                     * top_w[..., None], dim=2)  # (B, S, E)
    if cfg.act == "swiglu":
        h = (F.silu(torch.einsum("bsd,edf->bsef", x, p["w_gate"]))
             * torch.einsum("bsd,edf->bsef", x, p["w_up"]))
    else:
        h = gelu(torch.einsum("bsd,edf->bsef", x, p["w_up"]))
    y_all = torch.einsum("bsef,efd->bsed", h, p["w_down"])
    y = torch.sum(y_all * comb[..., None].to(y_all.dtype), dim=2)
    if cfg.shared_expert_ff:
        y = y + mlp(x, p["shared"], cfg.act)
    return y
