"""Convert the JAX reference's parameters and state into the port's.

The reference's trees arrive as numpy arrays (`jax.device_get(tree)`), so
this module needs neither JAX nor `repro`: a FedState of either package is a
NamedTuple with the same fields. The tests use it to start both sides from
the same mid-run state, shift tables and all.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import FedState, tree_map
from repro_torch.device import resolve_device


def params_from_jax(tree, device=None):
    """A tree of numpy arrays -> the same tree of tensors (dtype kept)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def state_from_jax(state, device=None) -> FedState:
    """A reference FedState of numpy arrays -> the port's FedState."""
    dev = resolve_device(device)

    def scalar(v, dtype):
        return torch.tensor(np.asarray(v).item(), dtype=dtype, device=dev)

    return FedState(
        params=params_from_jax(state.params, dev),
        shifts=params_from_jax(state.shifts, dev),
        server_h=params_from_jax(state.server_h, dev),
        rounds=scalar(state.rounds, torch.int32),
        bits=scalar(state.bits, torch.float32),
        bits_lo=scalar(state.bits_lo, torch.float32),
    )
