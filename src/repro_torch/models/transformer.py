"""Model assembly, dense family (port of `repro.models.transformer`).

Embeddings, a stack of pre-norm attention + SwiGLU blocks whose parameters
are stacked over layers (a leading L axis, as the reference scans them),
and an untied LM head. The parameter tree is the reference's, key for key:

    {"embed": (Vp, D), "blocks": {"ffn": {w_down, w_gate, w_up},
     "ln1": {bias, scale}, "ln2": {bias, scale}, "mixer": {wk, wo, wq, wv}},
     "final_norm": {bias, scale}, "lm_head": (Vp, D)}

so `core.api.tree_flatten` visits the leaves in JAX's order and the wire's
per-leaf draws land on the same leaves on both sides. Entry points:

    init_params(seed, cfg, device=None)   -> params
    forward(params, batch, cfg)           -> logits
    loss_fn(params, batch, cfg)           -> scalar loss (ce="gather")

The other families, the streaming CE and the prefill/decode paths come
later (ROADMAP Queue A 8).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import mixers
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    cross_entropy,
    embed_tokens,
    init_norm,
    lm_logits,
    mlp,
    norm,
)


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family (untied head) is ported yet "
            "(ROADMAP Queue A 8)")


def init_params(seed, cfg: ArchConfig, device=None):
    """Random parameters in cfg.dtype, drawn from `seed` (an int or a
    torch.Generator on `device`; device="meta" gives the shapes alone). The reference's shapes and scales
    (normal * 0.02 for the tables, normal / sqrt(fan_in) for the
    projections); the numbers differ, as any two generators do."""
    _check_dense(cfg)
    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    elif dev.type == "meta":  # shapes only (wire accounting): nothing drawn
        gen = None
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    d, f, vp, lead = cfg.d_model, cfg.d_ff, cfg.padded_vocab(), (cfg.num_layers,)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=cfg.dtype,
                           device=dev) * scale

    ffn = {"w_down": normal(lead + (f, d), f ** -0.5),
           "w_gate": normal(lead + (d, f), d ** -0.5),
           "w_up": normal(lead + (d, f), d ** -0.5)}
    mixer = mixers.init_attention(gen, cfg, dev, lead)
    blocks = {"ffn": ffn,
              "ln1": init_norm(d, cfg.norm, cfg.dtype, dev, lead),
              "ln2": init_norm(d, cfg.norm, cfg.dtype, dev, lead),
              "mixer": {k: mixer[k] for k in sorted(mixer)}}
    for key in ("ln1", "ln2"):
        blocks[key] = {k: blocks[key][k] for k in sorted(blocks[key])}
    final = init_norm(d, cfg.norm, cfg.dtype, dev)
    return {"embed": normal((vp, d), 0.02), "blocks": blocks,
            "final_norm": {k: final[k] for k in sorted(final)},
            "lm_head": normal((vp, d), 0.02)}


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _block_train(bp, x, cfg: ArchConfig, positions):
    h = norm(x, bp["ln1"], cfg.norm)
    x = x + mixers.attention_train(bp["mixer"], h, cfg, positions=positions)
    return x + mlp(norm(x, bp["ln2"], cfg.norm), bp["ffn"], cfg.act)


def forward(params, batch, cfg: ArchConfig, *, remat="full"):
    """Teacher-forced logits over the input tokens (all but the last).

    remat True/"full" recomputes each block's activations in the backward
    pass (`torch.utils.checkpoint`), which changes no number."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    inputs = tokens[:, :-1] if tokens.shape[1] > 1 else tokens
    b, s = inputs.shape
    x = embed_tokens(inputs, params["embed"])
    positions = _positions(b, s, x.device)
    # one unbind per stacked leaf: its backward stacks the layers' gradients
    # in one pass, where indexing layer by layer would add L full-size
    # zero-padded gradients per leaf
    layers = _unbind(params["blocks"])
    for i in range(params["blocks"]["ln1"]["scale"].shape[0]):
        bp = _layer(layers, i)
        if remat is True or remat == "full":
            x = torch.utils.checkpoint.checkpoint(
                _block_train, bp, x, cfg, positions, use_reentrant=False)
        else:
            x = _block_train(bp, x, cfg, positions)
    h = norm(x, params["final_norm"], cfg.norm)
    return lm_logits(h, params["lm_head"], cfg.vocab)


def _unbind(tree: Any):
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return tree.unbind(0)


def _layer(tree: Any, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def loss_fn(params, batch, cfg: ArchConfig, *, remat="full",
            ce: str = "gather"):
    """Mean next-token cross entropy in f32 (the reference's ce="gather")."""
    if ce != "gather":
        raise NotImplementedError(
            f"ce={ce!r} is not ported yet: the vocab-parallel streaming CE "
            "matters only under tensor parallelism (ROADMAP Queue A 8)")
    labels = batch["tokens"][:, 1:]
    logits = forward(params, batch, cfg, remat=remat)
    return cross_entropy(logits, labels, cfg.vocab)
