"""Simulator epoch loop and the train step's slot streams (port of
`repro.data.pipeline`'s `run_epochs`, `EpochIterator` and the slot
functions; the batch streams are still to port, ROADMAP Queue A 11)."""
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


class EpochIterator:
    """Walks a `ReshuffleSampler`'s order coherently across epochs.

    The position is one integer g, the per-client micro-step count consumed
    so far (all clients advance in lockstep, one column of the order matrix
    per micro-step); the sampler is stateless, so an iterator rebuilt at any
    g replays the identical stream.
    """

    def __init__(self, sampler: ReshuffleSampler, *, start: int = 0):
        if start < 0:
            raise ValueError(f"start={start}")
        self.sampler = sampler
        self._g = int(start)
        self._cached_epoch: int | None = None
        self._order: np.ndarray | None = None

    def _order_for(self, epoch: int) -> np.ndarray:
        if epoch != self._cached_epoch:
            self._order = self.sampler.epoch_order(epoch)
            self._cached_epoch = epoch
        return self._order

    def take(self, count: int) -> np.ndarray:
        """(M, count) batch indices of the next `count` micro-steps; a call
        may straddle an epoch boundary (RR-coherent rollover)."""
        cols = np.empty((self.sampler.m, count), np.int32)
        for j in range(count):
            epoch, i = divmod(self._g + j, self.sampler.n)
            cols[:, j] = self._order_for(epoch)[:, i]
        self._g += count
        return cols


def slots_for_step(sampler: ReshuffleSampler, step: int,
                   local_steps: int = 1) -> np.ndarray:
    """(M, local_steps) batch indices consumed by train step `step`."""
    return EpochIterator(sampler, start=step * local_steps).take(local_steps)


def shared_slots_at(sampler: ReshuffleSampler, micro_step: int,
                    count: int = 1, *, n_slots: int | None = None) -> np.ndarray:
    """(count,) SHARED slot indices from per-client micro-step `micro_step`.

    The per-slot wire needs every client of a level on the same slot per
    round, so the clients' orders must agree (`mode='rr_shared'`, or
    m == 1): raises when they diverge, and when `n_slots` (the wire's shift
    rows) does not cover the sampler's index range.
    """
    if n_slots is not None and sampler.n > n_slots:
        raise ValueError(
            f"sampler draws batch indices in [0, {sampler.n}) but the wire "
            f"has only n_slots={n_slots} shift rows — out-of-range slots "
            "would silently clamp onto the last row; build the aggregation "
            "with n_slots == sampler.n")
    cols = EpochIterator(sampler, start=micro_step).take(count)
    if not (cols == cols[:1]).all():
        raise ValueError(
            f"sampler mode {sampler.mode!r} gives clients different batch "
            "orders — the per-slot wire needs a shared order; use "
            "ReshuffleSampler(mode='rr_shared')")
    return cols[0]


def shared_slots_for_step(sampler: ReshuffleSampler, step: int,
                          local_steps: int = 1, *,
                          n_slots: int | None = None) -> np.ndarray:
    """(local_steps,) SHARED slot indices of full-participation train step
    `step`; see `shared_slots_at`."""
    return shared_slots_at(sampler, step * local_steps, local_steps,
                           n_slots=n_slots)
