"""Production fleet driver: partial participation around the train step
(port of `repro.fleet.driver`).

`launch.steps.make_train_step` builds a step for the mesh's M client
ranks; this driver decouples those ranks from the client *population*: each
round it samples a cohort of `M = num_clients(mesh)` clients from a
population of C (`CohortSampler`), copies the cohort's persistent shifts
from the host `ClientStateStore` into the TrainState's client-granular
shift table (`steps.with_cohort_shifts` — device memory stays O(cohort)),
feeds the cohort's batch rows from the per-cohort stream
(`data.pipeline.CohortStream`), and scatters the updated shifts back after
the step. The step itself is UNCHANGED — the same function a
full-participation run calls — which is what makes a `cohort ==
population` cohort-RR run bit-match the flat wire trajectory (DESIGN.md
§3.9).

Round t's generator is a pure function of the seed and the state's step
index (`core.salts.step_generator(seed, ROUNDS_KEY_SALT, step)`), as the
reference folds `state.step` into its fixed key, so a fleet run, a resumed
fleet run and the full-participation loop draw the same windows. The
runner reads the step index from the state once per `run` and counts on
the host from there.

The scatter fetches each per-client table leaf to the host once a round
(into pinned memory): the fleet's one required device-to-host copy.

Which TrainState field holds the per-client state depends on the mesh
topology: `shifts` when the client ranks form the inner wire level, and
`pod_shifts` on flat-mesh NASTYA (every client its own pod). Server/level
wire state (`mean_shift`; the pod tables on hierarchical meshes) stays on
the card across rounds, updated incrementally exactly as in full
participation; set `agg.mean_scale = M/C` so the resident mean shift tracks
the population mean.

Spread over processes (the step's collective a process group's), every
process runs the same rounds on the same global cohort, plan and cursors;
it feeds the rows of the client ranks it serves (`CohortStream`'s
`clients`), gathers their shift rows from their owners in the store and
scatters them back (`fleet.store.FleetPlacement`), so a run at any W
gives the one-process run's bits. `with_cohort_shifts` copies the served
ranks' rows into the process's rows of `shifts` (or of flat-mesh
NASTYA's `pod_shifts`).

`AsyncFleetRunner` is the buffered-async variant (DESIGN.md §3.10): the
server folds a round in once K of m reports arrive, late reports are
staleness-discounted or dropped with their RR cursor rewound, faults come
from the deterministic `fleet.chaos` layer, and the cohort can shrink/grow
between rounds via weight-0 padding — all on the SAME (elastic) step.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import salts
from repro_torch.core.api import tree_map
from repro_torch.data.pipeline import CohortStream, DevicePut
from repro_torch.device import resolve_device
from repro_torch.fleet.chaos import (
    AsyncPlanner,
    ChaosConfig,
    FaultyStore,
    TransientStoreError,
)
from repro_torch.fleet.cohort import CohortSampler
from repro_torch.fleet.store import ClientStateStore, host_copy
from repro_torch.launch import steps as _steps
from repro_torch.launch.mesh import num_clients


class FleetRunner:
    """Drives a train step over a sampled-cohort population.

    `step` is `make_train_step`'s step and `params` the parameter tree (any
    tree of the whole parameters' shapes: the wire's bytes per round
    derive from it); then the aggregation config, the population-sized
    client-stacked `data` and its stateless `ReshuffleSampler`, the
    `CohortSampler` and
    the `ClientStateStore`. Batches land on `device` (None: the card).
    `start_round` resumes the walk; the runner verifies the restored
    store's per-client cursors against the cohort walk's replay, so a
    checkpoint from a different cohort/sampler config cannot silently
    resume.
    """

    def __init__(self, step, params, *, agg, mesh, data=None, sampler,
                 cohorts: CohortSampler, store: ClientStateStore,
                 local_steps: int = 1, prefetch: bool = True,
                 start_round: int = 0, planner=None, paged=None,
                 device=None):
        m = num_clients(mesh)
        if cohorts.cohort_size != m:
            raise ValueError(
                f"cohort_size={cohorts.cohort_size} must equal the mesh's "
                f"client rank count {m} — the step is built for M mesh "
                "clients and the cohort fills exactly those ranks")
        if store.population != cohorts.population:
            raise ValueError(
                f"store population {store.population} != cohort sampler "
                f"population {cohorts.population}")
        agg = _steps.configure_agg(agg, mesh, local_steps)
        # which TrainState field carries the per-client tables this driver
        # round-trips: flat-mesh NASTYA maps each client onto its own pod
        self._shift_field = "shifts" if agg.client_axes else "pod_shifts"
        if store.has_shifts:
            want_slots = (agg.n_slots if agg.client_axes
                          else agg._pod_slots) if agg.rule.slotted else 1
            if store.n_slots != want_slots:
                raise ValueError(
                    f"store n_slots={store.n_slots} but the wire's "
                    f"{self._shift_field} tables carry {want_slots} slot "
                    "rows — create the store with the configured agg's "
                    "slot count (configure_agg collapses outer tables to "
                    "1 row on NASTYA paths)")
        self._slotted = agg.rule.slotted
        if self._slotted:
            # the per-slot wire reads/writes ONE shared table row per round
            # (DESIGN.md §3.8): every cohort client must sit at the same
            # data position, which cohort-RR keeps only when cohorts never
            # straddle a fleet-epoch boundary
            if cohorts.mode != "rr" or cohorts.population % m != 0:
                raise ValueError(
                    "per-slot methods (diana_rr) need cohort-RR with "
                    "population divisible by the cohort size: a cohort that "
                    "straddles a fleet-epoch boundary (or i.i.d. cohorts) "
                    "mixes clients at different data positions, and the "
                    "shared-slot wire contract breaks (DESIGN.md §3.9)")
            if sampler.mode != "rr_shared":
                raise ValueError(
                    "per-slot methods need ReshuffleSampler(mode="
                    "'rr_shared') so every client walks the same index "
                    "order (DESIGN.md §3.8)")
            n_slots = agg.n_slots if agg.client_axes else agg._pod_slots
            if sampler.n > n_slots:
                raise ValueError(
                    f"sampler draws batch indices in [0, {sampler.n}) but "
                    f"the wire has n_slots={n_slots} shift rows")
        self._step = step
        self._store = store
        self._local_steps = int(local_steps)
        self._pager = paged
        # the client ranks this process serves (all of them on one)
        served = agg.collective.local("rank", agg.num_pods())
        if (store.placement is not None
                and store.placement.slots != served):
            raise ValueError(f"the store's placement serves client ranks "
                             f"{store.placement.slots}, the step's "
                             f"collective {served}")
        self._stream = CohortStream(
            data, sampler, cohorts, local_steps=local_steps,
            put=DevicePut(resolve_device(device)), prefetch=prefetch,
            start_round=start_round, planner=planner, paged=paged,
            clients=served)
        if paged is not None:
            # all store I/O routes through the pager from here on; the
            # async subclass re-binds after its chaos FaultyStore wrap
            paged.bind_store(self._store)
        if not np.array_equal(store.cursor, self._stream.counts):
            bad = np.flatnonzero(store.cursor != self._stream.counts)
            shown = ", ".join(str(c) for c in bad[:8])
            more = f" (+{bad.size - 8} more)" if bad.size > 8 else ""
            raise ValueError(
                "store per-client cursors disagree with the cohort walk at "
                f"round {start_round} for client ids [{shown}]{more} — the "
                "checkpoint was written by a different cohort/sampler/"
                "chaos config (or rounds are missing)")
        # per-client uplink bits per round: this client's compressed slab on
        # the level it talks on (the intra-pod wire; on pod-granular NASTYA
        # meshes every client is its own pod and talks on the outer level)
        wire = agg.wire_bytes_per_round(params)
        self._bits_per_client = 8.0 * (
            wire["intra_pod"] if agg.client_axes else wire["inter_pod"])
        self._wire_dtype = agg.wire_dtype
        self._cohort_size = m
        self._step_index = None  # read from the state at the first run()
        telemetry.run_meta({
            "driver": type(self).__name__,
            "wire_bytes_per_round": {k: int(v) for k, v in wire.items()},
            "bits_per_client_round": self._bits_per_client,
            "wire_dtype": self._wire_dtype, "cohort": m,
            "population": store.population, "local_steps": self._local_steps})

    @property
    def store(self) -> ClientStateStore:
        return self._store

    @property
    def round(self) -> int:
        """Next unconsumed round (the checkpointable fleet cursor)."""
        return self._stream.round

    def checkpoint_meta(self) -> dict:
        """JSON-serializable fleet cursor + sampler/store specs for the
        checkpoint manifest (`checkpoint.save_fleet_checkpoint`)."""
        meta = {**self._stream.cursor_meta(),
                "store": self._store.spec(),
                "bits_per_client_round": self._bits_per_client,
                "wire_dtype": self._wire_dtype}
        if self._pager is not None:
            meta["data_store"] = self._pager.data.spec()
        return meta

    def _device_shifts(self, state):
        return getattr(state, self._shift_field)

    def _generator(self, state, seed: int):
        """This round's generator, from the state's step index (read from
        the card once per run, counted on the host after that)."""
        if self._step_index is None:
            self._step_index = int(state.step)
        return salts.step_generator(seed, salts.ROUNDS_KEY_SALT,
                                    self._step_index,
                                    state.step.device)

    def _gather(self, io, fr, state, retry=None):
        with telemetry.span("gather", round=fr.round):
            gathered = (io.gather(fr.cohort) if retry is None
                        else retry(io.gather, fr.cohort))
            return _steps.with_cohort_shifts(state, gathered,
                                             self._shift_field)

    def run(self, state, seed: int, rounds: int,
            callback: Callable[[int, Any, dict], None] | None = None):
        """Advance `rounds` fleet rounds from `state`; returns the final
        TrainState. `callback(round, state, metrics)` fires per round
        (logging/checkpoint hooks); the step's metrics arrive staged for
        the host (`telemetry.stage`). The store is updated in place."""
        store = self._store
        # paged runs route gather/scatter through the pager (one I/O
        # object for data pages and state rows); it delegates to the store
        io = self._pager if self._pager is not None else store
        for _ in range(rounds):
            fr = next(self._stream)
            state = self._gather(io, fr, state)
            gen = self._generator(state, seed)
            if self._slotted:
                if not (fr.cols == fr.cols[:1]).all():
                    raise RuntimeError(
                        "cohort clients disagree on the round's batch "
                        "indices — shared-slot invariant broken (this is a "
                        "bug: the constructor gates should have rejected "
                        "the config)")
                slots = fr.cols[0]
            else:
                slots = None
            with telemetry.span("device_step", round=fr.round):
                state, metrics = self._step(state, fr.batch, gen, slots)
            self._step_index += 1
            if store.has_shifts:
                with telemetry.span("scatter", round=fr.round):
                    io.scatter(fr.cohort, tree_map(
                        host_copy, self._device_shifts(state)))
            store.advance(fr.cohort, self._local_steps)
            store.add_bits(fr.cohort, self._bits_per_client)
            # one participation schema across sync/async: the sync round is
            # the degenerate plan where everyone reports on time, weight 1
            m = self._cohort_size
            metrics = telemetry.stage(dict(metrics))
            metrics.update(completed=m, on_time=m, weight_sum=float(m))
            telemetry.counter("fleet.uplink_bits",
                              m * self._bits_per_client, round=fr.round)
            telemetry.round_metrics(fr.round, metrics)
            if callback is not None:
                callback(fr.round, state, metrics)
        return state

    def close(self):
        self._stream.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AsyncFleetRunner(FleetRunner):
    """Buffered-async fleet rounds with deterministic fault injection
    (DESIGN.md §3.10).

    Per round an `AsyncPlanner` — a pure function of `(chaos seed, round)`
    — decides who reports on time (the K-of-m buffer trigger), who is late
    (staleness-discounted or dropped), who went dark, and which padded
    ranks an elastic resize masked out. The plan becomes:

      - the (m,) weights vector of the ELASTIC step (build it with
        `make_train_step(..., elastic=True)`): weight 0 masks a client out
        of the collective mean;
      - the `completes` mask driving exactly-once RR accounting: only
        completing clients scatter shifts / advance cursors / get the next
        data positions — everyone else re-enters the cohort walk at their
        pre-round position, shift tables untouched.

    A round with zero completers skips the step entirely (the server
    buffer never fills, so no update is applied; the step index does not
    advance — deterministic, so resume stays bit-exact).

    With chaos disabled and `buffer_k == m` every round is fully on-time
    with weight exactly 1.0 per rank — bitwise the synchronous trajectory.
    """

    def __init__(self, step, params, *, agg, mesh, data=None, sampler,
                 cohorts: CohortSampler, store: ClientStateStore,
                 buffer_k: int | None = None, late: str = "discount",
                 discount: float = 0.5, chaos: ChaosConfig | None = None,
                 resize: Callable[[int], int] | None = None,
                 local_steps: int = 1, prefetch: bool = True,
                 start_round: int = 0, paged=None, device=None):
        if local_steps != 1:
            raise ValueError(
                "async/elastic fleet rounds need local_steps == 1 (the "
                "elastic step rejects NASTYA epochs: a mid-local-epoch "
                "straggler has no well-defined RR rewind point)")
        self._chaos = chaos if chaos is not None else ChaosConfig()
        planner = AsyncPlanner(num_clients(mesh), buffer_k=buffer_k,
                               late=late, discount=discount,
                               chaos=self._chaos, resize=resize)
        super().__init__(step, params, agg=agg, mesh=mesh, data=data,
                         sampler=sampler, cohorts=cohorts, store=store,
                         local_steps=local_steps, prefetch=prefetch,
                         start_round=start_round, planner=planner,
                         paged=paged, device=device)
        if self._slotted and planner.may_defer:
            raise ValueError(
                "per-slot methods (diana_rr) cannot run with dropout, "
                "late='drop', or elastic resizing: a client whose cursor "
                "rewinds falls out of lockstep with its cohort and the "
                "shared-slot contract breaks (DESIGN.md §3.10) — use "
                "buffered staleness discounting (late='discount') only, "
                "or method='diana'")
        self._planner = planner
        if self._chaos.store_fail > 0:
            # wrap AFTER the cursor cross-check: injection hits the round
            # loop's store ops, not construction
            self._store = FaultyStore(self._store, self._chaos)
            if self._pager is not None:
                # re-bind so paged gather/scatter hit the SAME injection
                # schedule as the unpaged path
                self._pager.bind_store(self._store)

    def checkpoint_meta(self) -> dict:
        return {**super().checkpoint_meta(), "async": self._planner.spec()}

    def _io_retry(self, op, *args):
        """Bounded-retry wrapper for injected transient store failures;
        every retry is a fresh deterministic draw, backoff doubles."""
        c = self._chaos
        for attempt in range(c.max_retries + 1):
            try:
                return op(*args)
            except TransientStoreError:
                telemetry.counter("fleet.store_retry", 1,
                                  op=getattr(op, "__name__", str(op)))
                if attempt >= c.max_retries:
                    raise
                if c.backoff > 0:
                    time.sleep(c.backoff * 2 ** attempt)

    _STALE_BINS = (0.0, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, np.inf)

    def _participation(self, plan) -> dict:
        """Chaos counters + the raw (pre-normalization) participation mass:
        1.0 per on-time reporter plus the staleness discount of every late
        fold-in (`plan.weights` always sums to m after the rescale)."""
        late = plan.reported & ~plan.on_time
        raw = float(plan.on_time.sum())
        if self._planner.late == "discount" and late.any():
            raw += float(np.sum(
                self._planner.discount
                / (1.0 + plan.latency[late] - plan.deadline)))
        if telemetry.enabled():
            stale = plan.latency[late] - plan.deadline
            hist, _ = np.histogram(stale, bins=np.asarray(self._STALE_BINS))
            telemetry.counter("fleet.on_time", int(plan.on_time.sum()))
            telemetry.counter("fleet.late", int(late.sum()))
            telemetry.counter("fleet.dropped",
                              int(plan.on_time.size - plan.reported.sum()))
            telemetry.counter("fleet.staleness_hist", hist.tolist())
        return {"on_time": int(plan.on_time.sum()),
                "weight_sum": raw,
                "dropped": int(plan.on_time.size - plan.reported.sum()),
                "deadline": float(plan.deadline)}

    def run(self, state, seed: int, rounds: int,
            callback: Callable[[int, Any, dict], None] | None = None):
        """Advance `rounds` buffered-async fleet rounds. The metrics dict
        gains per-round participation stats (`on_time`, `completed`,
        `weight_sum`, `dropped`, `deadline` — the same schema the sync
        runner emits); zero-completer rounds report `{"skipped": True}`
        and leave the state untouched."""
        store = self._store
        io = self._pager if self._pager is not None else store
        for _ in range(rounds):
            fr = next(self._stream)
            plan = fr.plan
            comp = plan.completes
            n_comp = int(comp.sum())
            part = self._participation(plan)
            uplink = int(plan.reported.sum()) * self._bits_per_client
            telemetry.counter("fleet.uplink_bits", uplink, round=fr.round)
            if n_comp == 0:
                # the buffer never fills: no server update this round, but
                # reporters still burned uplink bits
                if plan.reported.any():
                    self._io_retry(store.add_bits, fr.cohort[plan.reported],
                                   self._bits_per_client)
                metrics = {"skipped": True, "completed": 0, **part}
                telemetry.round_metrics(fr.round, metrics)
                if callback is not None:
                    callback(fr.round, state, metrics)
                continue
            state = self._gather(io, fr, state, retry=self._io_retry)
            gen = self._generator(state, seed)
            weights = torch.from_numpy(plan.weights)
            slots = fr.cols[0] if self._slotted else None
            with telemetry.span("device_step", round=fr.round):
                state, metrics = self._step(state, fr.batch, gen, slots,
                                            weights)
            self._step_index += 1
            if store.has_shifts:
                # only completers persist their round: non-completing rows
                # of the device table are discarded (the next gather
                # overwrites them), leaving their store rows pre-round
                with telemetry.span("scatter", round=fr.round):
                    upd = tree_map(host_copy, self._device_shifts(state))
                    self._io_retry(io.scatter, fr.cohort, upd, comp)
            self._io_retry(store.advance, fr.cohort[comp], self._local_steps)
            self._io_retry(store.add_bits, fr.cohort[plan.reported],
                           self._bits_per_client)
            metrics = telemetry.stage(dict(metrics))
            metrics.update(completed=n_comp, **part)
            telemetry.round_metrics(fr.round, metrics)
            if callback is not None:
                callback(fr.round, state, metrics)
        return state
