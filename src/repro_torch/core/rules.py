"""The shift-rule layer (port of `repro.core.rules`): one source of truth for
the shift/control-variate arithmetic of every simulator method.

The paper's design space varies one thing between methods: what a client
remembers between rounds and how that memory shapes what crosses the wire.
Four rules cover every method:

``NoShift``      no memory: send Q(g)                 (SGD/QSGD/RR/Q-RR)
``SingleShift``  one DIANA control variate h per client: send Q(g - h),
                 h += alpha*Q  (DIANA, DIANA-NASTYA)
``PerSlotShift`` a table of n control variates per client, the round's batch
                 index selects the slot (DIANA-RR, Algorithm 3)
``EfRule``       error feedback (Stich et al. 2018): memory is the
                 compression residual e; send C(gamma*g + e), keep what the
                 compressor dropped ('ef_topk_rr')

The simulator's epoch functions (`core.algorithms`) call the rules on whole
client-stacked pytrees (leaves `(M, ...)`; the per-slot index is
`(arange(M), col)`). The fused DIANA update goes through the compression
backend, which has a tree entry point (`tree_diana_shift`, one kernel launch
over the raveled buffer) and a flat one (`diana_shift_flat`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.api import tree_map

Index = Any  # tuple of index tensors applied as table[idx], or None


def _lead_zeros(params, lead: tuple[int, ...], dtype):
    return tree_map(
        lambda p: torch.zeros(lead + tuple(p.shape), dtype=dtype or p.dtype,
                              device=p.device), params)


@dataclasses.dataclass(frozen=True)
class ShiftRule:
    """Protocol + shared plumbing for the four rules.

    Capability flags shape the simulator's state and epochs:

    needs_server_h  the simulator allocates `FedState.server_h`
    slotted         memory tables carry a leading slot axis (written in
                    place by `scatter`)
    supports_local  legal in the local (NASTYA) simulator family
    """

    name: str = "none"
    needs_server_h: bool = False
    slotted: bool = False
    supports_local: bool = True

    # -- state layout ---------------------------------------------------------

    def init_shifts(self, params, m: int | None = None, *, n_slots: int = 1,
                    dtype=None):
        """Zero memory tables shaped for this rule (None: no memory).

        m=None gives the per-rank layout (no client axis); an integer m
        prepends the stacked client axis. Slotted rules insert the `n_slots`
        axis next.
        """
        return None

    # -- per-round arithmetic -------------------------------------------------

    def select(self, shifts, idx: Index):
        """The active memory view for this round (slot tables index here)."""
        return shifts

    def payload(self, g, h, *, gamma: float = 1.0):
        """What goes through the compressor."""
        return g

    def update(self, h, q_own, mh, q_mean, *, alpha: float,
               beta: float | None = None, gamma: float = 1.0, backend,
               payload=None):
        """Post-compression arithmetic: (direction, h_new, mh_new).

        `q_own` is this client's compressed message, `q_mean` the aggregated
        one; the simulator's per-client view passes the same tree for both.
        `beta` is the mean-table stepsize (defaults to alpha).
        """
        return q_mean, None, None

    def scatter(self, shifts, idx: Index, h_new):
        """Write the round's updated memory back into the table."""
        return shifts

    # -- local (NASTYA) family server side ------------------------------------

    def direction(self, server_h, q_mean, *, alpha: float, gamma: float = 1.0,
                  backend):
        """(direction, new_server_h) from the aggregated epoch message."""
        return q_mean, server_h

    def table_axpy(self, shifts, q, *, alpha: float):
        """Local-family client-table update h += alpha*q."""
        return shifts


@dataclasses.dataclass(frozen=True)
class NoShift(ShiftRule):
    name: str = "none"


@dataclasses.dataclass(frozen=True)
class SingleShift(ShiftRule):
    """DIANA: one control variate per client, one mean per server."""

    name: str = "single"
    needs_server_h: bool = True

    def init_shifts(self, params, m=None, *, n_slots=1, dtype=None):
        return _lead_zeros(params, () if m is None else (m,), dtype)

    def payload(self, g, h, *, gamma: float = 1.0):
        return tree_map(torch.sub, g, h)

    def update(self, h, q_own, mh, q_mean, *, alpha, beta=None, gamma=1.0,
               backend, payload=None):
        # the fused path: direction = H + Q_mean, h' = h + alpha*Q_own,
        # H' = H + beta*Q_mean in ONE pass (kernels/diana_shift.py)
        if isinstance(h, torch.Tensor):
            return backend.diana_shift_flat(h, q_own, mh, q_mean, alpha=alpha,
                                            beta=beta)
        return backend.tree_diana_shift(h, q_own, mh, q_mean, alpha=alpha,
                                        beta=beta)

    def scatter(self, shifts, idx, h_new):
        return h_new

    def direction(self, server_h, q_mean, *, alpha, gamma=1.0, backend):
        d, _, new_h = self.update(server_h, q_mean, server_h, q_mean,
                                  alpha=alpha, gamma=gamma, backend=backend)
        return d, new_h

    def table_axpy(self, shifts, q, *, alpha):
        return tree_map(lambda h, qi: h + alpha * qi, shifts, q)


@dataclasses.dataclass(frozen=True)
class PerSlotShift(SingleShift):
    """DIANA-RR (Algorithm 3): n control variates per client; the batch
    index selects which one a round reads and writes. Same fused update as
    SingleShift — only the table layout and the select/scatter differ."""

    name: str = "per_slot"
    slotted: bool = True
    needs_server_h: bool = False
    supports_local: bool = False

    def init_shifts(self, params, m=None, *, n_slots=1, dtype=None):
        lead = (() if m is None else (m,)) + (n_slots,)
        return _lead_zeros(params, lead, dtype)

    def select(self, shifts, idx):
        if idx is None:
            idx = (0,)  # slot-less rounds (the NASTYA epoch gradient)
        return tree_map(lambda s: s[idx], shifts)

    def scatter(self, shifts, idx, h_new):
        """Write the round's rows IN PLACE: the epoch functions copy the
        tables once when the epoch starts, so a caller's state is never
        changed, and a round does not copy the whole (M, n, ...) table."""
        if idx is None:
            idx = (0,)

        def put(s, hn):
            s[idx] = hn
            return s

        return tree_map(put, shifts, h_new)


@dataclasses.dataclass(frozen=True)
class EfRule(ShiftRule):
    """Error feedback: memory is the compression residual. Needs a
    CONTRACTIVE compressor (Top-k in the simulator).

    The simulator form is p = gamma*g + e, direction = C(p)/gamma (the
    common `params - gamma*direction` update divides gamma back out).
    """

    name: str = "ef"
    supports_local: bool = False

    def init_shifts(self, params, m=None, *, n_slots=1, dtype=None):
        return _lead_zeros(params, () if m is None else (m,), dtype)

    def payload(self, g, h, *, gamma: float = 1.0):
        return tree_map(lambda gi, e: gamma * gi + e, g, h)

    def update(self, h, q_own, mh, q_mean, *, alpha, beta=None, gamma=1.0,
               backend, payload=None):
        direction = q_mean if gamma == 1.0 else tree_map(
            lambda q: q / gamma, q_mean)
        new_e = tree_map(torch.sub, payload, q_own)
        return direction, new_e, mh

    def scatter(self, shifts, idx, h_new):
        return h_new


RULES: dict[str, ShiftRule] = {
    "none": NoShift(),
    "single": SingleShift(),
    "per_slot": PerSlotShift(),
    "ef": EfRule(),
}


def get_rule(name: str) -> ShiftRule:
    try:
        return RULES[name]
    except KeyError:
        raise ValueError(
            f"unknown shift rule {name!r}; options: {sorted(RULES)}") from None
