"""Convert the JAX reference's parameters and state into the port's.

The reference's trees arrive as numpy arrays (`jax.device_get(tree)`), so
this module needs neither JAX nor `repro`: a FedState or TrainState of
either package is a NamedTuple with the same fields, and bf16 arrays
(numpy's `bfloat16` extension type) keep their bits. The tests use it to
start both sides from the same state, shift tables and all.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import FedState, tree_map
from repro_torch.device import resolve_device
from repro_torch.launch.steps import TrainState
from repro_torch.optim.optimizers import AdamState


def _tensor(a, dev) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_jax(tree, device=None):
    """A tree of numpy arrays -> the same tree of tensors (dtype kept)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)


def _scalar(v, dtype, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(v).item(), dtype=dtype, device=dev)


def state_from_jax(state, device=None) -> FedState:
    """A reference FedState of numpy arrays -> the port's FedState."""
    dev = resolve_device(device)
    return FedState(
        params=params_from_jax(state.params, dev),
        shifts=params_from_jax(state.shifts, dev),
        server_h=params_from_jax(state.server_h, dev),
        rounds=_scalar(state.rounds, torch.int32, dev),
        bits=_scalar(state.bits, torch.float32, dev),
        bits_lo=_scalar(state.bits_lo, torch.float32, dev),
    )


def train_state_from_jax(state, device=None) -> TrainState:
    """A reference TrainState of numpy arrays -> the port's TrainState:
    parameters, every shift table, the step and the optimizer's state
    (() for SGD, a param-shaped tree for momentum, AdamState for AdamW)."""
    dev = resolve_device(device)
    opt = state.opt_state
    if hasattr(opt, "mu"):
        opt = AdamState(mu=params_from_jax(opt.mu, dev),
                        nu=params_from_jax(opt.nu, dev),
                        count=_scalar(opt.count, torch.int32, dev))
    elif opt != ():
        opt = params_from_jax(opt, dev)
    return TrainState(
        params=params_from_jax(state.params, dev),
        shifts=params_from_jax(state.shifts, dev),
        mean_shift=params_from_jax(state.mean_shift, dev),
        step=_scalar(state.step, torch.int32, dev),
        opt_state=opt,
        pod_shifts=params_from_jax(state.pod_shifts, dev),
        pod_mean_shift=params_from_jax(state.pod_mean_shift, dev),
    )
