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
`(arange(M), col)`). The production wire (`core.dist`) calls them per leaf
on rank-stacked tables (the per-slot index is the round's one shared slot,
`(slice(None), slot)`), and maps its method names to rules through
`WIRE_RULES`. The fused DIANA update goes through the compression
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

    Capability flags shape the state and the rounds of both consumers:

    has_shifts      the rule keeps per-client/rank memory
    has_mean        the rule keeps a running mean table (the wire's
                    `mean_shift`)
    needs_server_h  the simulator allocates `FedState.server_h`
    slotted         memory tables carry a leading slot axis (written in
                    place by `scatter`)
    supports_local  legal in the local (NASTYA) simulator family
    contractive     the wire applies the UNSCALED (contractive) window to
                    this rule's payload (error feedback diverges under the
                    unbiased nb/kb-scaled reconstruction)
    """

    name: str = "none"
    has_shifts: bool = False
    has_mean: bool = False
    needs_server_h: bool = False
    slotted: bool = False
    supports_local: bool = True
    contractive: bool = False

    # -- state layout ---------------------------------------------------------

    # analysis: allow[ignored-argument] a memory-free rule keeps no tables
    def init_shifts(self, params, m: int | None = None, *, n_slots: int = 1,
                    dtype=None):
        """Zero memory tables shaped for this rule (None: no memory).

        m=None gives the per-rank layout (no client axis); an integer m
        prepends the stacked client axis. Slotted rules insert the `n_slots`
        axis next.
        """
        return None

    # -- per-round arithmetic -------------------------------------------------

    # analysis: allow[ignored-argument] unslotted tables have one view
    def select(self, shifts, idx: Index):
        """The active memory view for this round (slot tables index here)."""
        return shifts

    # analysis: allow[ignored-argument] the shift-free payload is the raw
    # gradient (DIANA's g - h needs no stepsize)
    def payload(self, g, h, *, gamma: float = 1.0):
        """What goes through the compressor."""
        return g

    # analysis: allow[ignored-argument] memory-free rule: the direction is the
    # aggregate itself
    def update(self, h, q_own, mh, q_mean, *, alpha: float,
               beta: float | None = None, gamma: float = 1.0, backend,
               payload=None):
        """Post-compression arithmetic: (direction, h_new, mh_new).

        `q_own` is this client's compressed message, `q_mean` the aggregated
        one; the simulator's per-client view passes the same tree for both.
        `beta` is the mean-table stepsize (defaults to alpha).
        """
        return q_mean, None, None

    # analysis: allow[ignored-argument] no tables to write back
    def scatter(self, shifts, idx: Index, h_new):
        """Write the round's updated memory back into the table."""
        return shifts

    # -- local (NASTYA) family server side ------------------------------------

    # analysis: allow[ignored-argument] the shift-free server applies the
    # aggregate directly
    def direction(self, server_h, q_mean, *, alpha: float, gamma: float = 1.0,
                  backend):
        """(direction, new_server_h) from the aggregated epoch message."""
        return q_mean, server_h

    # analysis: allow[ignored-argument] no client tables to update
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
    has_shifts: bool = True
    has_mean: bool = True
    needs_server_h: bool = True

    # analysis: allow[ignored-argument] unslotted: one shift per client
    def init_shifts(self, params, m=None, *, n_slots=1, dtype=None):
        return _lead_zeros(params, () if m is None else (m,), dtype)

    # analysis: allow[ignored-argument] the shift-free payload is the raw
    # gradient (DIANA's g - h needs no stepsize)
    def payload(self, g, h, *, gamma: float = 1.0):
        return tree_map(torch.sub, g, h)

    # analysis: allow[ignored-argument] the fused DIANA update needs only
    # alpha and beta
    def update(self, h, q_own, mh, q_mean, *, alpha, beta=None, gamma=1.0,
               backend, payload=None):
        # the fused path: direction = H + Q_mean, h' = h + alpha*Q_own,
        # H' = H + beta*Q_mean in ONE pass (kernels/diana_shift.py)
        if isinstance(h, torch.Tensor):
            return backend.diana_shift_flat(h, q_own, mh, q_mean, alpha=alpha,
                                            beta=beta)
        return backend.tree_diana_shift(h, q_own, mh, q_mean, alpha=alpha,
                                        beta=beta)

    # analysis: allow[ignored-argument] the unslotted table IS the round's view
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
    has_shifts: bool = True
    supports_local: bool = False
    contractive: bool = True

    # analysis: allow[ignored-argument] EF keeps one residual per client
    def init_shifts(self, params, m=None, *, n_slots=1, dtype=None):
        return _lead_zeros(params, () if m is None else (m,), dtype)

    def payload(self, g, h, *, gamma: float = 1.0):
        return tree_map(lambda gi, e: gamma * gi + e, g, h)

    # analysis: allow[ignored-argument] EF's memory is payload - q: no
    # stepsize, no kernel
    def update(self, h, q_own, mh, q_mean, *, alpha, beta=None, gamma=1.0,
               backend, payload=None):
        direction = q_mean if gamma == 1.0 else tree_map(
            lambda q: q / gamma, q_mean)
        new_e = tree_map(torch.sub, payload, q_own)
        return direction, new_e, mh

    # analysis: allow[ignored-argument] the unslotted table IS the round's view
    def scatter(self, shifts, idx, h_new):
        return h_new


RULES: dict[str, ShiftRule] = {
    "none": NoShift(),
    "single": SingleShift(),
    "per_slot": PerSlotShift(),
    "ef": EfRule(),
}


# production wire method name -> rule ('dense' skips compression entirely
# but shares NoShift's no-memory semantics)
WIRE_RULES: dict[str, ShiftRule] = {
    "dense": RULES["none"],
    "q": RULES["none"],
    "diana": RULES["single"],
    "diana_rr": RULES["per_slot"],
    "ef": RULES["ef"],
}


def get_rule(name: str) -> ShiftRule:
    try:
        return RULES[name]
    except KeyError:
        raise ValueError(
            f"unknown shift rule {name!r}; options: {sorted(RULES)}") from None
