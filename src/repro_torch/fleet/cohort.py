"""Cohort sampling: client-level random reshuffling over a population
(a copy of `repro.fleet.cohort`: the same draws, the same cohorts).

The paper states its algorithms for M workers that all participate every
round; `launch/steps.py` realizes exactly that — the mesh's ("pod","data")
ranks ARE the M clients. A real federated fleet samples a small cohort from
a population `C >> M` each round. Without-replacement *client* sampling is
the fleet-level analog of the paper's RR theme (cf. Malinovsky & Richtárik,
arXiv:2205.03914; Mishchenko, Khaled & Richtárik, arXiv:2102.06704): shuffle
the population once per *fleet epoch* and walk it in cohorts, so every
client participates exactly once per fleet epoch.

The sampler follows the same statelessness discipline as
`data.reshuffle.ReshuffleSampler` (DESIGN.md §3.7): the raw per-epoch
permutation is a pure function of `(seed, epoch)`, and a round's cohort is
a pure function of the round index — the walk is a single integer cursor
`g = round * cohort_size` over the concatenation of the fleet epochs'
orders, so a cohort may straddle a fleet-epoch boundary (tail of epoch e +
head of epoch e+1) exactly like `EpochIterator` straddles data epochs.
That is what makes the fleet run resumable from a `(fleet_epoch, round)`
cursor with no sampler state to checkpoint.

**Straddle deconfliction.** Two adjacent epochs' permutations are
independent, so a straddling cohort could sample the same client twice —
ill-defined for the state-store scatter (two mesh ranks would write one
client's shifts). The walk therefore reads each epoch's EFFECTIVE order
(`effective_order`): the raw permutation with its head deconflicted
against the previous epoch's effective tail — the straddling round takes
the first head elements NOT in the tail, and the displaced elements keep
their later positions. Each effective order is still a permutation of the
population (exactly-once-per-epoch coverage is preserved) and still a pure
function of the seed: epoch e's order depends only on the raw draws of
epochs ≤ e, chained through (< cohort_size)-element tail windows that are
memoized, so random access to any round stays cheap.

Cohorts are returned SORTED ascending. Membership is a set — the order in
which a cohort's clients map onto mesh ranks is an implementation choice —
and the canonical ascending assignment is what makes a
`cohort == population` run place client c on rank c every round, i.e.
bit-match the full-participation wire (DESIGN.md §3.9).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import salts

COHORT_MODES = ("rr", "with_replacement")


class CohortSampler:
    """Yields per-round client cohorts from a population of C clients.

    mode:
      'rr'  — cohort-RR: one permutation of the population per fleet epoch
              (`np.random.default_rng((seed, epoch))`, head-deconflicted
              across epoch boundaries — see the module docstring), walked
              in chunks of `cohort_size`; every client participates exactly
              once per fleet epoch, cohorts may straddle epoch boundaries
              and are always distinct within a round.
      'with_replacement' — the baseline control: each round draws an
              independent uniform cohort (i.i.d. across rounds). Within a
              round the cohort is still distinct clients — a client
              appearing twice would make the state-store scatter
              ill-defined.
    """

    def __init__(self, population: int, cohort_size: int, *,
                 mode: str = "rr", seed: int = 0):
        if mode not in COHORT_MODES:
            raise ValueError(
                f"unknown cohort mode {mode!r}; options: {COHORT_MODES}")
        if cohort_size < 1 or population < cohort_size:
            raise ValueError(
                f"need 1 <= cohort_size <= population, got "
                f"cohort_size={cohort_size}, population={population}")
        self.population = int(population)
        self.cohort_size = int(cohort_size)
        self.mode = mode
        self.seed = int(seed)
        self._order_cache: dict[int, np.ndarray] = {}  # effective orders
        self._tails: dict[int, np.ndarray] = {}  # (< m)-element tail windows

    # -- the stateless order ------------------------------------------------

    def epoch_order(self, fleet_epoch: int) -> np.ndarray:
        """(C,) RAW permutation of the population for `fleet_epoch` — a
        pure function of (seed, fleet_epoch). The walk itself reads
        `effective_order` (head-deconflicted); this is the underlying
        draw."""
        rng = np.random.default_rng((self.seed, int(fleet_epoch)))
        return rng.permutation(self.population).astype(np.int64)

    def _straddle(self, fleet_epoch: int) -> int:
        """How many slots of the round containing this epoch's first slot
        belong to the PREVIOUS epoch (0 = the boundary is round-aligned)."""
        return (fleet_epoch * self.population) % self.cohort_size

    def _build_effective(self, fleet_epoch: int) -> np.ndarray:
        """Effective order of one epoch, given the previous epoch's cached
        tail window: move the first straddle-conflicting head elements out
        of the straddling round's reach (they keep their later positions)."""
        raw = self.epoch_order(fleet_epoch)
        a = self._straddle(fleet_epoch)
        if fleet_epoch == 0 or a == 0:
            return raw
        tail = self._tails[fleet_epoch - 1][-a:]
        k = self.cohort_size - a  # head slots the straddling round fills
        clear = np.flatnonzero(~np.isin(raw, tail))[:k]
        return np.concatenate([raw[clear], np.delete(raw, clear)])

    def effective_order(self, fleet_epoch: int) -> np.ndarray:
        """(C,) permutation the walk actually reads for `fleet_epoch` —
        `epoch_order` with the straddle deconfliction applied. Memoized;
        the chain of tail windows is built forward from the nearest
        round-aligned (or already-cached) epoch, so random access costs
        O(C) per uncached epoch, not a recursion to epoch 0 each call."""
        e = int(fleet_epoch)
        order = self._order_cache.get(e)
        if order is not None:
            return order
        start = e
        while start > 0 and self._straddle(start) != 0 \
                and (start - 1) not in self._tails:
            start -= 1
        win = min(self.cohort_size - 1, self.population)
        order = None
        for ep in range(start, e + 1):
            if ep < e and ep in self._tails:
                continue  # tail already known; full order not needed
            order = self._build_effective(ep)
            if win:
                self._tails[ep] = order[-win:]
        self._order_cache[e] = order
        while len(self._order_cache) > 2:
            self._order_cache.pop(next(iter(self._order_cache)))
        return order

    def cohort_for_round(self, rnd: int) -> np.ndarray:
        """(cohort_size,) sorted DISTINCT client ids for round `rnd`."""
        if rnd < 0:
            raise ValueError(f"round={rnd}")
        m = self.cohort_size
        if self.mode == "with_replacement":
            # 3-element entropy tuple (with a salt) — disjoint from the
            # 2-element (seed, epoch) sequences the 'rr' mode draws from
            rng = np.random.default_rng(
                (self.seed, salts.WR_COHORT_SALT, int(rnd)))
            ids = rng.choice(self.population, size=m, replace=False)
            return np.sort(ids.astype(np.int64))
        g = rnd * m
        out = np.empty((m,), np.int64)
        filled = 0
        while filled < m:
            epoch, i = divmod(g + filled, self.population)
            take = min(m - filled, self.population - i)
            out[filled:filled + take] = \
                self.effective_order(epoch)[i:i + take]
            filled += take
        return np.sort(out)

    # -- cursor / accounting ------------------------------------------------

    def cursor(self, rnd: int) -> tuple[int, int]:
        """(fleet_epoch, position-within-epoch) of the NEXT round's first
        slot — the checkpointable fleet cursor."""
        return divmod(rnd * self.cohort_size, self.population)

    @property
    def rounds_per_epoch(self) -> float:
        return self.population / self.cohort_size

    def participation_counts(self, rnd: int) -> np.ndarray:
        """(C,) number of rounds each client participated in during rounds
        [0, rnd).

        'rr' has a closed form (no replay): after `rnd * cohort_size` walk
        slots, every client holds `full_epochs` participations and the
        first `rem` clients of the current epoch's EFFECTIVE order hold one
        more. 'with_replacement' replays the per-round draws (O(rnd·m)
        host work — the price of the i.i.d. baseline; prefer checkpointing
        the state-store cursors for long runs).
        """
        counts = np.zeros((self.population,), np.int64)
        if self.mode == "with_replacement":
            for r in range(rnd):
                counts[self.cohort_for_round(r)] += 1
            return counts
        g = rnd * self.cohort_size
        full_epochs, rem = divmod(g, self.population)
        counts += full_epochs
        if rem:
            counts[self.effective_order(full_epochs)[:rem]] += 1
        return counts

    def spec(self) -> dict:
        """JSON-serializable description (checkpointed next to the fleet
        cursor so a resumed run can verify it is replaying the same walk)."""
        return {"population": self.population,
                "cohort_size": self.cohort_size,
                "mode": self.mode, "seed": self.seed}
