"""Deterministic fault injection + buffered-async round planning (a copy
of `repro.fleet.chaos`: the same schedules; DESIGN.md §3.10).

Production fleets lose clients mid-round: some go dark (dropout), some
report late (stragglers), and the host store occasionally hiccups
(transient I/O). This module makes every one of those failure modes a PURE
FUNCTION of `(seed, round)` so a chaos run is exactly reproducible — the
same seed replays the same darkness/latency/I/O schedule, a resumed run
replays the prefix it skipped, and tests can assert trajectories bit-for-bit.

Three pieces:

``ChaosConfig``
    The knobs: per-round client dropout probability, straggler
    probability + delay, transient store-I/O failure rate with bounded
    retry/backoff, and the seed every draw derives from.

``AsyncPlanner``
    FedBuff-style K-of-m round planning. Each round it simulates report
    latencies for the cohort, sets the buffer deadline at the K-th fastest
    alive client, and emits a `ParticipationPlan`: per-rank participation
    weights for the elastic step (`launch.steps.make_train_step(...,
    elastic=True)`), plus the `completes` mask that drives exactly-once RR
    accounting — a client's data cursor advances ONLY when its report is
    folded in, so a dropped/late-dropped client re-enters the cohort walk
    at its pre-round position with its shift table untouched.

``FaultyStore``
    A `ClientStateStore` wrapper whose gather/scatter/advance/add_bits
    raise deterministic
    `TransientStoreError`s; the async driver retries with bounded
    exponential backoff (`AsyncFleetRunner._io_retry`). Injection happens
    BEFORE the underlying op, so a store op either happens atomically or
    raises — retries never double-apply.

Weight normalization is the bit-match trick: raw weights are rescaled so
that a fully-on-time cohort gets exactly 1.0 everywhere, and `x * 1.0` is
an IEEE754 no-op — chaos disabled + buffer_k == m reproduces the
synchronous trajectory bit-for-bit (tests/test_fleet.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np

# salts folded into the seeded generators so the independent fault channels
# (darkness, latency, store I/O) never share a stream; registered (and
# uniqueness-checked) in repro_torch.core.salts
from repro_torch.core.salts import (
    CHAOS_DROP_SALT as _SALT_DROP,
    CHAOS_IO_SALT as _SALT_IO,
    CHAOS_LATENCY_SALT as _SALT_LATENCY,
)

LATE_POLICIES = ("discount", "drop")


class TransientStoreError(RuntimeError):
    """An injected (recoverable) store-I/O failure — retry the op."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Deterministic fault-injection knobs (all off by default).

    dropout     P(a cohort client goes dark for the round — never reports)
    straggler   P(an alive client reports late)
    delay       mean extra latency a straggler adds (in units of the base
                round latency, which is uniform [0, 1))
    store_fail  P(one store gather/scatter raises TransientStoreError)
    max_retries bounded retry budget per store op
    backoff     base seconds for exponential retry backoff (0 = don't sleep)
    seed        every draw derives from (seed, salt, round) — same seed,
                same faults
    """

    dropout: float = 0.0
    straggler: float = 0.0
    delay: float = 1.0
    store_fail: float = 0.0
    max_retries: int = 3
    backoff: float = 0.0
    seed: int = 0

    def __post_init__(self):
        for name in ("dropout", "straggler", "store_fail"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name}={v} must be in [0, 1)")
        if self.delay < 0:
            raise ValueError(f"delay={self.delay}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries={self.max_retries}")

    @property
    def any_faults(self) -> bool:
        return (self.dropout > 0 or self.straggler > 0
                or self.store_fail > 0)

    def spec(self) -> dict:
        """JSON-serializable config for the checkpoint manifest."""
        return dataclasses.asdict(self)


def _rng(seed: int, salt: int, rnd: int) -> np.random.Generator:
    return np.random.default_rng((int(seed), int(salt), int(rnd)))


class ParticipationPlan(NamedTuple):
    """One round's deterministic participation outcome (host-side).

    weights:   (m,) f32 per-rank wire weights, pre-normalized so a fully
               on-time round is exactly 1.0 everywhere (bitwise no-op);
    completes: (m,) bool — fold the report in: scatter shifts, advance the
               RR data cursor. ~completes clients re-enter the cohort walk
               at their pre-round position (exactly-once);
    reported:  (m,) bool — the client transmitted this round (uplink bits
               are charged even when a late report is dropped);
    latency:   (m,) simulated report latencies (inf = dark/padded);
    deadline:  the K-th fastest alive latency (the buffer trigger);
    on_time:   (m,) bool — alive AND within the deadline. This is the
               truth for participation metrics: the normalized `weights`
               can exceed 1.0 for discounted LATE reports whenever the
               rescale factor m/sum(w) > 1 (any late/dark client), so
               thresholding weights misclassifies them.
    """

    weights: np.ndarray
    completes: np.ndarray
    reported: np.ndarray
    latency: np.ndarray
    deadline: float
    on_time: np.ndarray


class AsyncPlanner:
    """FedBuff K-of-m round planner: a pure function `(round, cohort) ->
    ParticipationPlan` shared by the stream (cursor accounting) and the
    driver (wire weights).

    buffer_k  the server applies the update once this many reports arrive
              (None = cohort size m: wait for everyone — synchronous);
    late      'discount': late reports fold in with weight
              discount / (1 + staleness), cursor advances;
              'drop': late reports are discarded, weight 0, cursor rewound
              (never advanced) so the client re-reads the same RR batches
              next time it is sampled;
    discount  the staleness-discount numerator;
    resize    optional round -> active cohort size (<= m): elastic
              shrink/grow between rounds. Ranks past the active count are
              padding — weight 0, no cursor advance, no bits — so the
              compiled step never sees a shape change.
    """

    def __init__(self, m: int, *, buffer_k: int | None = None,
                 late: str = "discount", discount: float = 0.5,
                 chaos: ChaosConfig | None = None,
                 resize: Callable[[int], int] | None = None):
        if late not in LATE_POLICIES:
            raise ValueError(
                f"late={late!r}; options: {LATE_POLICIES}")
        if buffer_k is not None and not 1 <= buffer_k <= m:
            raise ValueError(
                f"buffer_k={buffer_k} must be in [1, cohort size {m}]")
        if not 0.0 < discount <= 1.0:
            raise ValueError(f"discount={discount} must be in (0, 1]")
        self.m = int(m)
        self.buffer_k = self.m if buffer_k is None else int(buffer_k)
        self.late = late
        self.discount = float(discount)
        self.chaos = chaos if chaos is not None else ChaosConfig()
        self.resize = resize

    @property
    def may_defer(self) -> bool:
        """True when some cohort client may finish a round without its
        cursor advancing (dropout, late-drop, or elastic padding) —
        incompatible with the shared-slot (diana_rr) cursor contract."""
        return (self.chaos.dropout > 0 or self.late == "drop"
                or self.resize is not None)

    def spec(self) -> dict:
        return {"buffer_k": self.buffer_k, "late": self.late,
                "discount": self.discount, "elastic_resize":
                self.resize is not None, "chaos": self.chaos.spec()}

    def __call__(self, rnd: int, cohort: np.ndarray) -> ParticipationPlan:
        m, c = self.m, self.chaos
        active = np.ones(m, bool)
        if self.resize is not None:
            a = int(self.resize(rnd))
            if not 1 <= a <= m:
                raise ValueError(
                    f"resize({rnd}) = {a} outside [1, {m}] — the padded "
                    "cohort can shrink below m but never below 1 or past "
                    "the compiled cohort size")
            active[a:] = False
        dark = np.zeros(m, bool)
        if c.dropout > 0:
            dark = _rng(c.seed, _SALT_DROP, rnd).random(m) < c.dropout
        lat_rng = _rng(c.seed, _SALT_LATENCY, rnd)
        latency = lat_rng.random(m)
        if c.straggler > 0:
            strag = lat_rng.random(m) < c.straggler
            latency = latency + strag * c.delay * (1.0 + lat_rng.random(m))
        alive = active & ~dark
        latency = np.where(alive, latency, np.inf)
        n_alive = int(alive.sum())
        weights = np.zeros(m, np.float64)
        completes = np.zeros(m, bool)
        if n_alive == 0:
            return ParticipationPlan(weights.astype(np.float32), completes,
                                     alive.copy(), latency, np.inf,
                                     np.zeros(m, bool))
        k = min(self.buffer_k, n_alive)
        deadline = float(np.partition(latency, k - 1)[k - 1])
        on_time = alive & (latency <= deadline)
        late = alive & ~on_time
        weights[on_time] = 1.0
        completes |= on_time
        if self.late == "discount":
            # staleness-discounted fold-in: the work is kept, so the RR
            # cursor advances — exactly-once is preserved by consumption
            weights[late] = self.discount / (1.0 + latency[late] - deadline)
            completes |= late
        # normalize so the collective mean over m ranks weights reports by
        # w / sum(w) * m; a fully on-time cohort gives exactly 1.0 per rank
        # (m / m), which the elastic wire multiplies in as a bitwise no-op
        weights = weights * (m / weights.sum())
        return ParticipationPlan(weights.astype(np.float32), completes,
                                 alive, latency, deadline, on_time)


class FaultyStore:
    """Deterministic transient-failure wrapper around a `ClientStateStore`.

    gather/scatter/advance/add_bits draw from `(seed, round-robin call
    index)` and raise `TransientStoreError` BEFORE touching the underlying
    store when the draw fires — the op either happens atomically or not at
    all, so the driver's bounded retry (a fresh call index per attempt) can
    never double-apply a scatter or a cursor advance. All other attributes
    delegate uninjected (`touch` is a prefetch hint, `as_tree` a
    checkpoint read — neither sits on the retried round path).

    The call index counts the cohort operations, which every process of
    a spread fleet makes in the same order with the same cohort (its own
    rows move inside the operation, `fleet.store`): every process draws
    the same failures and retries together, before any row crosses a
    process, and follows the one-process run's trajectory.
    """

    def __init__(self, store, chaos: ChaosConfig):
        self._store = store
        self._chaos = chaos
        self._calls = 0
        self.injected_failures = 0

    def _maybe_fail(self, op: str) -> None:
        n = self._calls
        self._calls += 1
        if _rng(self._chaos.seed, _SALT_IO, n).random() < self._chaos.store_fail:
            self.injected_failures += 1
            raise TransientStoreError(
                f"injected transient store {op} failure (I/O call {n})")

    def gather(self, cohort):
        self._maybe_fail("gather")
        return self._store.gather(cohort)

    def scatter(self, cohort, updated, done=None):
        self._maybe_fail("scatter")
        return self._store.scatter(cohort, updated, done)

    def advance(self, cohort, micro_steps):
        self._maybe_fail("advance")
        return self._store.advance(cohort, micro_steps)

    def add_bits(self, cohort, bits_per_client):
        self._maybe_fail("add_bits")
        return self._store.add_bits(cohort, bits_per_client)

    def __getattr__(self, name):
        return getattr(self._store, name)
