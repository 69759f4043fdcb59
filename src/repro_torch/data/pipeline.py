"""Simulator epoch loop (port of `repro.data.pipeline.run_epochs`; the rest
of the reference's data pipeline belongs to a later slice)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import tree_leaves
from repro_torch.data.reshuffle import ReshuffleSampler


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator of epoch `epoch`: a pure function of (seed, epoch), as
    the reference folds the epoch into its key, so a run resumed at epoch e
    draws what the uninterrupted run drew."""
    entropy = int(np.random.SeedSequence((seed, epoch)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(entropy)


def run_epochs(epoch_fn, state, data, sampler: ReshuffleSampler, *,
               epochs: int, seed: int = 0, start_epoch: int = 0,
               draws=None, callback=None):
    """Drive a simulator epoch fn (`core.algorithms.make_epoch_fn`) through
    the stateless host-side sampler.

    Each epoch e receives `sampler.epoch_order(e)` as its `order` and the
    generator `epoch_generator(seed, e)`, so the trajectory is a pure
    function of `(state, data, sampler, seed, e)`. `draws(e)`, when given,
    returns epoch e's compressor draws (see `core.algorithms`) in place of
    the generator's. `callback(e, state)` fires after each epoch and does
    not influence the trajectory.
    """
    device = tree_leaves(data)[0].device
    for e in range(start_epoch, start_epoch + epochs):
        order = torch.from_numpy(sampler.epoch_order(e)).to(device)
        state = epoch_fn(state, data, epoch_generator(seed, e, device), order,
                         None if draws is None else draws(e))
        if callback is not None:
            callback(e, state)
    return state
