"""Central RNG salt registry (port of `repro.core.salts`).

Every stochastic draw is a pure function of a structured entropy tuple
``(seed, salt, round/epoch)``; the salt keeps independent channels (wire
levels, fault channels, dataset synthesis, cohort baselines) from sharing a
stream when a user reuses one integer seed across subsystems. The values
are the reference's, so the numpy channels (cohorts, chaos, modality
stubs) draw exactly what the reference draws.

Import the NAMES, never restate the values. `_register` raises at import
time on a duplicate value or name.

`step_generator(seed, salt, step, device)` takes the place of the
reference's `root_key`: the reference passes one fixed key every step and
folds the step index in inside the jitted step; the port's step draws from
a `torch.Generator` that it advances. A generator carried across steps is
in no checkpoint, so each step's generator is derived afresh from the step
index, which makes a resumed run draw what the uninterrupted run drew.
"""
from __future__ import annotations

import numpy as np
import torch

_REGISTRY: dict[str, int] = {}


def _register(name: str, value: int) -> int:
    if name in _REGISTRY:
        raise ValueError(f"salt {name!r} registered twice")
    if value in _REGISTRY.values():
        clash = next(k for k, v in _REGISTRY.items() if v == value)
        raise ValueError(
            f"salt value {value:#x} of {name!r} collides with {clash!r} — "
            "two channels would share an entropy stream")
    _REGISTRY[name] = int(value)
    return int(value)


def registered_salts() -> dict[str, int]:
    """Name -> value snapshot."""
    return dict(_REGISTRY)


# -- wire (core.dist) --------------------------------------------------------
POD_KEY_SALT = _register("POD_KEY_SALT", 0x70D5)
WIRE_QUANT_SALT = _register("WIRE_QUANT_SALT", 0xB175)

# -- NASTYA sub-streams (launch.steps) ---------------------------------------
NASTYA_PERM_SALT = _register("NASTYA_PERM_SALT", 1)
NASTYA_LOCAL_SALT = _register("NASTYA_LOCAL_SALT", 2)

# -- fleet (fleet.cohort / fleet.chaos) --------------------------------------
# (seed, WR_COHORT_SALT, round) for the i.i.d. with-replacement baseline;
# the three fault channels (darkness, latency, store I/O) never share a
# stream even under one chaos seed
WR_COHORT_SALT = _register("WR_COHORT_SALT", 0x5EED)
CHAOS_DROP_SALT = _register("CHAOS_DROP_SALT", 0xD42C)
CHAOS_LATENCY_SALT = _register("CHAOS_LATENCY_SALT", 0x1A7E)
CHAOS_IO_SALT = _register("CHAOS_IO_SALT", 0x10FA)

# -- dataset synthesis (launch.train modality stubs) -------------------------
MODALITY_STUB_SALT = _register("MODALITY_STUB_SALT", 0x3D0D)

# -- root streams (launch) ---------------------------------------------------
PARAMS_KEY_SALT = _register("PARAMS_KEY_SALT", 0x9A2A)
ROUNDS_KEY_SALT = _register("ROUNDS_KEY_SALT", 0x207D)
SERVE_KEY_SALT = _register("SERVE_KEY_SALT", 0x5E2E)


def step_generator(seed: int, salt: int, step: int | None, device):
    """A fresh `torch.Generator` on `device` seeded by a pure function of
    (seed, salt, step): the generator of train step (or fleet round)
    `step`; `step=None` gives the root stream of `salt` (parameter
    initialization)."""
    words = (int(seed), int(salt)) + (() if step is None else (int(step),))
    entropy = int(np.random.SeedSequence(words).generate_state(
        1, dtype=np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device).manual_seed(entropy)
