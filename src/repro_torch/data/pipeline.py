"""NASTYA-aware streaming data pipeline (port of `repro.data.pipeline`;
DESIGN.md §3.7).

This module owns what the production loop consumes:

  - the epoch-indexed RR order (`EpochIterator` over a stateless
    `ReshuffleSampler`), consumed coherently ACROSS epoch boundaries;
  - client-major batch assembly: every leaf of the emitted batch has
    `m * local_steps * b` leading rows, client-major (the contract of
    `launch.steps.make_train_step`), every leaf gathered through the same
    RR index stream so modalities stay row-aligned;
  - uneven per-client dataset sizes with explicit drop-remainder semantics;
  - host-side double-buffered prefetch: while the step runs batch t, one
    worker thread assembles batch t+1 and `put`s it on the card;
  - a checkpointable cursor `(epoch, step)` so a restored run bit-reproduces
    the data stream from any point, mid-epoch included;
  - the per-cohort view of a population (`CohortStream`, the fleet's
    stream) and the simulator's epoch loop (`run_epochs`).

Host batches are CPU tensors (numpy inputs are taken without a copy; bf16
arrays keep their bits). The sampler side is numpy. The card enters only
through the `put` callable: `DevicePut` copies each batch from pinned host
memory with `non_blocking=True` on a side CUDA stream and records an event
behind the copy; the stream hands the batch over only after the consuming
(current) stream waits on that event, and `record_stream` keeps the
allocator from reusing the batch's memory while the step still reads it.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.api import tree_leaves, tree_map
from repro_torch.data.reshuffle import ReshuffleSampler

PutFn = Callable[[dict], Any]


def host_tensor(x) -> torch.Tensor:
    """A host array as a CPU tensor without a copy; a numpy bf16 array
    (the reference's `ml_dtypes` type) keeps its bits."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# ---------------------------------------------------------------------------
# placing batches on the card
# ---------------------------------------------------------------------------

class InFlight:
    """A batch whose host-to-device copies are queued on a side stream,
    with the event recorded behind them."""

    __slots__ = ("batch", "event")

    def __init__(self, batch: dict, event):
        self.batch = batch
        self.event = event

    def land(self) -> dict:
        """Make the current stream wait for the copies (no host wait) and
        mark the batch as used there, so the allocator keeps its memory
        until the step is done with it."""
        cur = torch.cuda.current_stream(tree_leaves(self.batch)[0].device)
        cur.wait_event(self.event)
        for t in tree_leaves(self.batch):
            t.record_stream(cur)
        return self.batch


def _land(built):
    return built.land() if isinstance(built, InFlight) else built


class DevicePut:
    """The streams' `put` for `device`. On a CUDA device each leaf is
    pinned and copied with `non_blocking=True` on this put's own side
    stream, which keeps the copy from queueing behind the running step (a
    copy on the default stream would) and from blocking the host (a copy
    from pageable memory would); it returns an `InFlight` that the stream
    lands on the consuming stream. Elsewhere it is a plain `.to(device)`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._side = None

    def __call__(self, batch: dict):
        if self.device.type != "cuda":
            return {k: v.to(self.device) for k, v in batch.items()}
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._side):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self._side)
        return InFlight(out, event)


# ---------------------------------------------------------------------------
# client-stacked data normalization (uneven sizes, drop-remainder)
# ---------------------------------------------------------------------------

def _normalize_leaf(name: str, leaf, m: int):
    """A leaf is either a stacked (m, n, b, ...) array or a length-m sequence
    of per-client (n_c, b, ...) arrays (uneven datasets). Returns
    (per-client views, per-client batch counts)."""
    if isinstance(leaf, (list, tuple)):
        views = [host_tensor(c) for c in leaf]
    else:
        arr = host_tensor(leaf)
        if arr.ndim < 2:
            raise ValueError(
                f"leaf {name!r}: expected client-stacked (m, n, ...) data, "
                f"got shape {tuple(arr.shape)}")
        views = [arr[c] for c in range(arr.shape[0])]
    if len(views) != m:
        raise ValueError(
            f"leaf {name!r}: {len(views)} clients, sampler has {m}")
    return views, [v.shape[0] for v in views]


def normalize_client_data(data: Mapping[str, Any], m: int, *,
                          drop_remainder: bool = True):
    """Validate a client-stacked data dict and resolve a common per-client
    batch count n.

    drop_remainder=True: clients with more than min_c n_c batches have their
    tail batches dropped (never sampled), keeping every client in lockstep —
    the explicit analogue of the paper's equal-n assumption. With
    drop_remainder=False uneven sizes are an error.

    Returns (views, n): views[name] is a length-m list of (n_or_more, b, ...)
    tensors, n the usable per-client batch count.
    """
    if not isinstance(data, Mapping) or not data:
        raise ValueError("data must be a non-empty mapping of named leaves")
    views: dict[str, list[torch.Tensor]] = {}
    counts: dict[str, list[int]] = {}
    for name, leaf in data.items():
        views[name], counts[name] = _normalize_leaf(name, leaf, m)
    all_counts = {c for per_leaf in counts.values() for c in per_leaf}
    n = min(all_counts)
    if len(all_counts) > 1 and not drop_remainder:
        raise ValueError(
            f"uneven per-client batch counts {sorted(all_counts)} with "
            "drop_remainder=False — pad every client to the same n (the "
            "paper assigns the remainder to the last worker) or pass "
            "drop_remainder=True to truncate to the minimum")
    if n < 1:
        raise ValueError("some client holds zero batches")
    return views, n


# ---------------------------------------------------------------------------
# the epoch-indexed RR cursor
# ---------------------------------------------------------------------------

class EpochIterator:
    """Walks a `ReshuffleSampler`'s order coherently across epochs.

    The position is one integer g, the per-client micro-step count consumed
    so far (all clients advance in lockstep, one column of the order matrix
    per micro-step); `(epoch, step) = divmod(g, n)` is the checkpointable
    cursor, and since the sampler is stateless an iterator rebuilt at any g
    replays the identical stream.
    """

    def __init__(self, sampler: ReshuffleSampler, *, start: int = 0):
        if start < 0:
            raise ValueError(f"start={start}")
        self.sampler = sampler
        self._g = int(start)
        self._cached_epoch: int | None = None
        self._order: np.ndarray | None = None

    @property
    def global_step(self) -> int:
        return self._g

    @property
    def cursor(self) -> tuple[int, int]:
        """(epoch, step-within-epoch) of the NEXT micro-step to be drawn."""
        return divmod(self._g, self.sampler.n)

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


# ---------------------------------------------------------------------------
# the streams
# ---------------------------------------------------------------------------

class _PrefetchStream:
    """Shared double-buffered prefetch lifecycle for the batch streams.

    Subclasses implement `_plan()` (calling thread ONLY — it advances the
    stream's cursor, so worker timing can never reorder the walk),
    `_build(plan)` (worker thread: assembly + `put`, whose copies overlap
    the running step), and `_emit(plan, built)` (calling thread:
    bookkeeping + the yielded value). With `prefetch=True` exactly one
    built batch is kept in flight. A failed plan/build POISONS the stream
    — the cursor no longer matches the batches actually delivered, and a
    caught-and-retried next() must not silently skip a batch.
    """

    def __init__(self, prefetch: bool):
        self._pool = ThreadPoolExecutor(max_workers=1) if prefetch else None
        self._pending = None
        self._closed = False

    def _plan(self):
        raise NotImplementedError

    def _build(self, plan):
        raise NotImplementedError

    def _emit(self, plan, built):
        raise NotImplementedError

    def _build_traced(self, plan):
        # spans fire from the worker thread on prefetch paths — the sink's
        # per-thread nesting keeps them on their own trace track
        with telemetry.span("assemble", stream=type(self).__name__):
            return self._build(plan)

    def _submit(self):
        plan = self._plan()
        fut = (self._pool.submit(self._build_traced, plan)
               if self._pool is not None else None)
        return plan, fut

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise ValueError(
                f"{type(self).__name__} is closed (or died on a failed "
                "assemble/put) — its cursor no longer matches the emitted "
                "batches; rebuild the stream from the last checkpointed "
                "cursor")
        try:
            if self._pool is None:
                plan, _ = self._submit()
                return self._emit(plan, _land(self._build_traced(plan)))
            if self._pending is None:
                self._pending = self._submit()
            (plan, fut), self._pending = self._pending, self._submit()
            return self._emit(plan, _land(fut.result()))
        except BaseException:
            self.close()
            raise

    def close(self):
        self._closed = True
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
            self._pending = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BatchStream(_PrefetchStream):
    """Iterator of client-major `(m * local_steps * b)`-row train batches.

    Each `next()` yields one train step's feed: for every client c, its
    `local_steps` next RR micro-batches (in order), stacked client-major —
    rows `[c*ls*b, (c+1)*ls*b)` belong to client c. All leaves are gathered
    with the same index stream, so multi-modal rows stay aligned.
    `clients` (a slice of the m clients) keeps the rows of those clients
    only: a process's own when the ranks are spread over processes, each
    process walking the same RR order (the processes that hold one
    client's model shards all take that client's rows).
    """

    def __init__(self, data: Mapping[str, Any], sampler: ReshuffleSampler, *,
                 local_steps: int = 1, put: PutFn | None = None,
                 prefetch: bool = True, drop_remainder: bool = True,
                 start_step: int = 0, clients: slice = slice(None)):
        if local_steps < 1:
            raise ValueError(f"local_steps={local_steps}")
        self._views, n_avail = normalize_client_data(
            data, sampler.m, drop_remainder=drop_remainder)
        if sampler.n > n_avail:
            raise ValueError(
                f"sampler indexes {sampler.n} batches/client but the data "
                f"holds only {n_avail} usable batches/client")
        self.m = sampler.m
        self._clients = clients
        self.n = sampler.n  # batches beyond sampler.n are dropped remainder
        self.local_steps = int(local_steps)
        self._put = put
        self._start_step = int(start_step)
        self._consumed = 0  # train steps handed to the caller
        self._it = EpochIterator(sampler, start=start_step * local_steps)
        super().__init__(prefetch)

    @property
    def step(self) -> int:
        """Train steps consumed so far (including `start_step`)."""
        return self._start_step + self._consumed

    @property
    def cursor(self) -> tuple[int, int]:
        """(epoch, step-within-epoch) of the next UNCONSUMED micro-step —
        prefetched-but-not-yet-returned batches don't count."""
        return divmod(self.step * self.local_steps, self.n)

    def cursor_meta(self) -> dict:
        """JSON-serializable cursor + sampler spec, for the checkpoint
        manifest. Resume with `make_batch_stream(..., start_step=
        meta['train_step'])` after checking `sampler` matches."""
        epoch, step = self.cursor
        return {"train_step": self.step,
                "global_micro_step": self.step * self.local_steps,
                "epoch": epoch, "step": step,
                "local_steps": self.local_steps,
                "sampler": self._it.sampler.spec()}

    def _plan(self) -> np.ndarray:
        return self._it.take(self.local_steps)

    def _build(self, cols: np.ndarray):
        return _assemble_rows(self._views, range(self.m)[self._clients],
                              cols[self._clients], self._put)

    def _emit(self, cols: np.ndarray, built):
        self._consumed += 1
        return built


def _assemble_rows(views: dict, clients, cols: np.ndarray,
                   put: PutFn | None):
    """Client-major row assembly — THE row contract, shared by the
    full-participation and per-cohort streams: for the i-th client in
    `clients`, its `cols[i, :]` batches in order, every leaf gathered by
    the same index stream (modalities stay row-aligned), then `put`."""
    ls = cols.shape[1]
    out = {}
    for name, v in views.items():
        rows = [v[int(c)][int(cols[i, j])]
                for i, c in enumerate(clients) for j in range(ls)]
        out[name] = torch.cat(rows, dim=0)
    return put(out) if put is not None else out


def make_batch_stream(data: Mapping[str, Any], sampler: ReshuffleSampler, *,
                      local_steps: int = 1,
                      extras: Mapping[str, Any] | None = None,
                      put: PutFn | None = None, prefetch: bool = True,
                      drop_remainder: bool = True,
                      start_step: int = 0,
                      clients: slice = slice(None)) -> BatchStream:
    """Build the production input stream.

    data / extras: named client-stacked leaves — `(m, n, b, ...)` arrays or
    length-m lists of `(n_c, b, ...)` arrays. `extras` (VLM patches, audio
    frames, ...) are merged into the same stream so every modality's rows
    are gathered by the same RR indices as the tokens.

    put: applied to each assembled host batch on the prefetch thread —
    typically `DevicePut(device)`, so the copy overlaps the running step.

    start_step: first train step to emit (the checkpointed cursor's
    `train_step`); the stream is identical to a fresh run that consumed
    `start_step` steps.

    clients: the clients whose rows the stream emits (a process's own
    slice of the mesh's client ranks, `launch.sharding.local_clients`:
    every model-shard process of a client gets the same rows); all of
    them by default.
    """
    if extras:
        overlap = set(data) & set(extras)
        if overlap:
            raise ValueError(f"extras duplicate data leaves: {sorted(overlap)}")
        data = {**data, **extras}
    return BatchStream(data, sampler, local_steps=local_steps, put=put,
                       prefetch=prefetch, drop_remainder=drop_remainder,
                       start_step=start_step, clients=clients)


# ---------------------------------------------------------------------------
# the per-cohort stream view (fleet partial participation, DESIGN.md §3.9)
# ---------------------------------------------------------------------------

class ClientOrderWalk:
    """Memoized per-client (cursor -> batch index) lookup over a stateless
    `ReshuffleSampler` — the one copy of the divmod-into-epoch-order walk
    that both the per-cohort stream and the simulator fleet driver
    (`core.algorithms.run_fleet_rounds`) consume."""

    def __init__(self, sampler: ReshuffleSampler, *, cache: int = 8):
        self.sampler = sampler
        self._cache = int(cache)
        self._orders: dict[int, np.ndarray] = {}

    def order_for(self, epoch: int) -> np.ndarray:
        order = self._orders.get(epoch)
        if order is None:
            order = self.sampler.epoch_order(epoch)
            self._orders[epoch] = order
            while len(self._orders) > self._cache:
                self._orders.pop(next(iter(self._orders)))
        return order

    def cols_at(self, clients: np.ndarray, counts: np.ndarray,
                local_steps: int = 1) -> np.ndarray:
        """(len(clients), local_steps) batch indices: client i's next
        `local_steps` RR positions starting at ITS OWN micro-step cursor
        `counts[i]` (each client draws from its own epoch's permutation)."""
        n = self.sampler.n
        cols = np.empty((clients.size, local_steps), np.int32)
        for j in range(local_steps):
            epochs, i = np.divmod(counts + j, n)
            for e in np.unique(epochs):
                sel = epochs == e
                cols[sel, j] = self.order_for(int(e))[clients[sel], i[sel]]
        return cols


class FleetRound(NamedTuple):
    """One round's feed from a `CohortStream`.

    cohort: (m,) sorted client ids participating this round;
    cols:   (m, local_steps) per-client batch indices consumed — client i's
            next RR micro-batches at ITS OWN data cursor;
    batch:  the assembled (and `put`-applied) client-major
            `(m * local_steps * b)`-row batch, `BatchStream`'s row contract;
    plan:   the round's `ParticipationPlan` when the stream has a planner
            (buffered-async fleets, `fleet.chaos`): only clients with
            `plan.completes` had their cursor advanced. None on
            synchronous streams.
    """

    round: int
    cohort: np.ndarray
    cols: np.ndarray
    batch: Any
    plan: Any = None


class CohortStream(_PrefetchStream):
    """Per-cohort view of a population-sized client-stacked dataset.

    Each round samples a cohort of `cohort_size` clients from a population
    of C and assembles rows for the sampled clients ONLY, each at its own
    RR position:

      - per-client micro-step cursors, advanced only on participation —
        derived in closed form from the stateless `CohortSampler`
        (`participation_counts`), so the stream is a pure function of
        `(data, data_sampler, cohort_sampler, start_round)` and resumes
        bit-exactly from a round index;
      - per-client epoch boundaries via `ClientOrderWalk`;
      - `BatchStream`'s client-major assembly and modality alignment, with
        the `_PrefetchStream` double-buffer/poisoning lifecycle.

    With `cohort == population` under cohort-RR every round samples every
    client in ascending order and the emitted batches are exactly
    `BatchStream`'s — the fleet bit-match invariant (DESIGN.md §3.9).

    `paged=` (a `data.paging.LookaheadPager`, exclusive with `data=`) swaps
    the in-RAM tree for the out-of-core store behind the SAME per-cohort
    view; after each build the stream calls `paged.advance_window(t,
    cohort_sampler)` on the prefetch worker, so the next cohort's pages
    load while the current round's step runs (DESIGN.md §3.11).

    `clients` (a slice of the cohort's m client ranks) keeps the rows of
    those ranks only: a process's own when the fleet spreads over
    processes, as `BatchStream`'s. The cohort, the cursors and the plan
    stay global, every process walking them the same way; a paged
    stream pages in only those ranks' clients.
    """

    def __init__(self, data: Mapping[str, Any] | None,
                 sampler: ReshuffleSampler,
                 cohort_sampler, *, local_steps: int = 1,
                 put: PutFn | None = None, prefetch: bool = True,
                 drop_remainder: bool = True, start_round: int = 0,
                 planner=None, paged=None, clients: slice = slice(None)):
        if local_steps < 1:
            raise ValueError(f"local_steps={local_steps}")
        self._clients = clients
        if sampler.m != cohort_sampler.population:
            raise ValueError(
                f"data sampler covers {sampler.m} clients but the cohort "
                f"sampler draws from a population of "
                f"{cohort_sampler.population}")
        if paged is not None:
            if data is not None:
                raise ValueError(
                    "pass data= (in-RAM client-stacked tree) OR paged= "
                    "(LookaheadPager over an on-disk ClientDataStore), "
                    "not both")
            if paged.population != sampler.m:
                raise ValueError(
                    f"paged store holds {paged.population} clients but the "
                    f"data sampler covers {sampler.m}")
            self._views, n_avail = paged.views, paged.n_batches
        else:
            self._views, n_avail = normalize_client_data(
                data, sampler.m, drop_remainder=drop_remainder)
        self._paged = paged
        if sampler.n > n_avail:
            raise ValueError(
                f"sampler indexes {sampler.n} batches/client but the data "
                f"holds only {n_avail} usable batches/client")
        self.sampler = sampler
        self.cohorts = cohort_sampler
        self.local_steps = int(local_steps)
        self._put = put
        self._round = int(start_round)
        # `planner` ((round, cohort) -> plan with a `.completes` bool mask)
        # gates cursor advancement: a sampled client consumes its batches
        # only when its report completes (exactly-once, DESIGN.md §3.10)
        self._planner = planner
        if planner is None:
            self.counts = (cohort_sampler.participation_counts(start_round)
                           * self.local_steps)
        else:
            # under faults the closed form is invalid — replay the planner
            # over the skipped prefix (pure in round, O(start_round * m))
            self.counts = np.zeros(cohort_sampler.population, np.int64)
            for t in range(int(start_round)):
                cohort = cohort_sampler.cohort_for_round(t)
                done = planner(t, cohort).completes
                self.counts[cohort[done]] += self.local_steps
        self._walk = ClientOrderWalk(sampler)
        super().__init__(prefetch)

    @property
    def round(self) -> int:
        """Next UNCONSUMED round (prefetched batches don't count)."""
        return self._round - (0 if self._pending is None else 1)

    def cursor_meta(self) -> dict:
        """JSON-serializable fleet cursor + sampler specs for the
        checkpoint manifest; resume with `start_round=meta['round']`."""
        fleet_epoch, pos = self.cohorts.cursor(self.round)
        return {"round": self.round, "fleet_epoch": fleet_epoch,
                "epoch_position": pos, "local_steps": self.local_steps,
                "cohort_sampler": self.cohorts.spec(),
                "sampler": self.sampler.spec()}

    def _plan(self) -> tuple[int, np.ndarray, np.ndarray, Any]:
        t = self._round
        cohort = self.cohorts.cohort_for_round(t)
        cols = self._walk.cols_at(cohort, self.counts[cohort],
                                  self.local_steps)
        if self._planner is None:
            self.counts[cohort] += self.local_steps
            part = None
        else:
            part = self._planner(t, cohort)
            self.counts[cohort[part.completes]] += self.local_steps
        self._round = t + 1
        return t, cohort, cols, part

    def _build(self, plan):
        t, cohort, cols, _ = plan
        own = self._clients
        built = _assemble_rows(self._views, cohort[own], cols[own],
                               self._put)
        if self._paged is not None:
            # closed-form lookahead: round t is assembled, so prefetch the
            # pages rounds t+1.. will touch and evict the rest
            self._paged.advance_window(t, self.cohorts, own)
        return built

    def _emit(self, plan, built) -> FleetRound:
        t, cohort, cols, part = plan
        return FleetRound(t, cohort, cols, built, part)


# ---------------------------------------------------------------------------
# slot streams (production DIANA-RR: which shift slot each round touches)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# the simulator's epoch loop
# ---------------------------------------------------------------------------

def abstract_stream_batch(batch, local_steps: int = 1):
    """The stream's batch as the dry run sees it, given one round's
    client-major batch specs (leading dim m * b, tensors that hold no
    memory: `configs.shapes.input_specs`): each leaf's leading dim becomes
    m * local_steps * b, the batch contract of `make_batch_stream`."""
    return tree_map(
        lambda s: s.new_empty((s.shape[0] * local_steps,) + tuple(s.shape[1:])),
        batch)


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
