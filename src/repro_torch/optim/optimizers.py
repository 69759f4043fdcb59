"""Pytree optimizers (port of `repro.optim.optimizers`).

The reference's optax-like interface:

    opt = adamw(3e-4)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Moments are f32 whatever the parameters' dtype; the arithmetic keeps the
reference's association (`-lr * g`, `b1 * m + (1 - b1) * g`, ...).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.api import tree_leaves, tree_map

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: (-lr) * g, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                              device=p.device), params)

    def update(grads, state, params=None):
        new_m = tree_map(lambda m, g: beta * m + g.to(_F32), state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: (-lr) * (beta * m + g), new_m, grads)
        else:
            upd = tree_map(lambda m: (-lr) * m, new_m)
        return upd, new_m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)
        dev = tree_leaves(params)[0].device
        return AdamState(mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params),
                         count=torch.zeros((), dtype=torch.int32, device=dev))

    def update(grads, state, params):
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(_F32),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(_F32)),
                      state.nu, grads)
        c1 = 1 - b1 ** count.to(_F32)
        c2 = 1 - b2 ** count.to(_F32)

        def upd(m, v, p):
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            return (-lr) * (step + weight_decay * p.to(_F32))

        return tree_map(upd, mu, nu, params), AdamState(mu=mu, nu=nu,
                                                        count=count)

    return Optimizer(init, update)


def clip_by_global_norm(grads, max_norm: float):
    sq = None
    for g in tree_leaves(grads):
        s = torch.sum(torch.square(g.to(_F32)))
        sq = s if sq is None else sq + s
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm
