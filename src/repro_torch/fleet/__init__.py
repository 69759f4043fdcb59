"""Partial participation at population scale (port of `repro.fleet`;
DESIGN.md §3.9–3.10).

The mesh's client ranks stop being *the* M clients and become the cohort
slots a population of C >> M clients rotates through:

- `CohortSampler` — client-level random reshuffling: shuffle the population
  once per fleet epoch, walk it in cohorts (every client participates
  exactly once per fleet epoch), with an i.i.d. `with_replacement` baseline;
- `ClientStateStore` — host-backed (mmap-friendly) sharded store of
  per-client persistent state: DIANA shifts / DIANA-RR slot tables, data
  cursors, uplink bit counters; `gather(cohort)`/`scatter(cohort, ...)` are
  the O(cohort) device boundary;
- `FleetRunner` — drives the UNCHANGED train step over sampled cohorts
  (`launch.steps.with_cohort_shifts` copies the gathered slices in);
- `AsyncFleetRunner` — buffered-async rounds: FedBuff-style K-of-m buffer
  trigger, staleness-discounted or dropped late reports with exactly-once
  RR cursor rewind, elastic cohort resizing via weight-0 padding, and the
  deterministic fault-injection layer in `fleet.chaos`.

The simulator cross-check lives in `core.algorithms.run_fleet_rounds`.
"""
from repro_torch.fleet.chaos import (
    LATE_POLICIES,
    AsyncPlanner,
    ChaosConfig,
    FaultyStore,
    ParticipationPlan,
    TransientStoreError,
)
from repro_torch.fleet.cohort import COHORT_MODES, CohortSampler
from repro_torch.fleet.driver import AsyncFleetRunner, FleetRunner
from repro_torch.fleet.store import ClientStateStore, FleetPlacement

__all__ = [
    "COHORT_MODES",
    "LATE_POLICIES",
    "AsyncFleetRunner",
    "AsyncPlanner",
    "ChaosConfig",
    "CohortSampler",
    "ClientStateStore",
    "FaultyStore",
    "FleetPlacement",
    "FleetRunner",
    "ParticipationPlan",
    "TransientStoreError",
]
