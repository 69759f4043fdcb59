"""Host-backed sharded per-client state store for fleet-scale training
(port of `repro.fleet.store`).

Device memory holds O(cohort) state; the population's persistent per-client
state lives here, on the host, sharded along the client axis:

  - DIANA shifts: one control variate per client (`(C, *param)` per leaf) or
    a DIANA-RR slot table (`(C, n_slots, *param)`), in the wire's
    `shift_dtype` so a gather/scatter round-trip is lossless;
  - per-client data cursors: micro-steps each client has consumed (drives
    the per-cohort batch stream, `data.pipeline.CohortStream`);
  - per-client uplink bit counters (float64 — host-side, no x64 ceremony).

Each leaf is a list of `shard_size`-row CPU tensors. With `path=...` the
shards are `np.memmap` files (one per leaf per shard, the reference's
names) seen as tensors — zero pages are never materialized, so a
10^5-client store costs disk sparsely and RSS only for the rows actually
touched. `gather(cohort)` returns host `(m, [n_slots,] *param)` slices
that `launch.steps.with_cohort_shifts` copies into the state's tables;
`scatter(cohort, updated)` writes the round's results back, fetching each
leaf from the card once. The wire and simulator run unchanged math on the
gathered slice (DESIGN.md §3.9).

Spread over processes (a `FleetPlacement`), a process holds only the
rows of the clients it owns, each row its model shards' slice of every
split shift leaf (as `launch.sharding.StateShards` splits the stacked
tables), in files of its own under `path` (`{leaf}.{shard}.p{rank}.dat`,
zero pages untouched as above). `gather(cohort)` returns the rows of the
client ranks the process serves, each received from the client's owner
where another process owns it; `scatter` sends them back; both move rows
process to process over the collective's "fleet" level
(`launch.distributed`, counted there, `launch.sharding.fleet_bytes`).
Cursors and bit counters stay (C,) host arrays that every process
updates the same way from the round's plan. A checkpoint of the spread
store is the one-process store's tree (`checkpoint_parts`): process 0
writes every owner's rows put together leaf by leaf, and any layout
reads its own rows back.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.core.api import tree_flatten, tree_leaves, tree_paths
from repro_torch.data.paging import stored_dtype
from repro_torch.data.pipeline import host_tensor
from repro_torch.launch.distributed import RankLayout

_FLEET = "fleet"  # the collective's level (and byte counter) of the rows
SHARD_ROWS = 65_536  # a store shard's rows by default (the reference's)


class FleetPlacement:
    """Where a fleet's per-client rows live over processes: the
    processes of one model index (the collective's "fleet" level) share
    the population, each holding its model shards' slice of every split
    shift leaf. The round's client rank i is served by the process whose
    client ranks hold i (`RankLayout.local_ranks`); client c is owned,
    whatever the round, by the process at position c mod P among the P
    processes of its model index, so every process knows every owner
    without a table, across hosts and with or without a memmap path.
    `axes` is each shift leaf's split axis in its parameter (None:
    whole), `model` the mesh's T."""

    def __init__(self, comm, ranks: int, pods: int, model: int,
                 axes=None):
        self.comm = comm
        self.layout = RankLayout(comm.world, comm.rank, ranks, pods, model)
        self.pods, self.model = pods, model
        self.axes = tuple(axes) if axes is not None else None
        self.procs = self.layout.client_world
        self.me = comm.rank // self.layout.model_procs
        self.slots = self.layout.local_ranks

    @classmethod
    def of(cls, agg, ranks: int) -> "FleetPlacement | None":
        """The placement of `agg`'s collective (bound to the mesh and the
        parameters, `launch.steps.configure_agg`) for `ranks` client
        ranks; None on one process, which holds every row."""
        if agg.collective.world == 1:
            return None
        return cls(agg.collective, ranks, agg.num_pods(), agg.model_size,
                   agg.model_axes if agg.model_size > 1 else None)

    def owner(self, c: int) -> int:
        """The client process (position among the P) that owns client c."""
        return int(c) % self.procs

    def server(self, i: int) -> int:
        """The client process that serves client rank i."""
        return int(i) // self.layout.local

    def peer(self, q: int) -> int:
        """The global rank of client process q at this model index."""
        mp = self.layout.model_procs
        return q * mp + self.comm.rank % mp

    def owned(self, lo: int, hi: int) -> range:
        """The clients in [lo, hi) this process owns."""
        first = lo + (self.me - lo) % self.procs
        return range(first, hi, self.procs)

    def row(self, c) -> np.ndarray:
        """The store row of an owned client (or an id array of them)."""
        return np.asarray(c, np.int64) // self.procs


def _leaf_paths(tree):
    leaves, unflatten = tree_flatten(tree)
    return tree_paths(tree), leaves, unflatten


class ClientStateStore:
    """Sharded host store of per-client persistent state.

    Build with :meth:`create` (zeros, the fresh-run layout) and restore a
    checkpoint into it with :meth:`load_tree`. `population` rows are split
    into ceil(C / shard_size) shards; every accessor takes a SORTED cohort
    id vector (the canonical order `CohortSampler` emits).
    """

    def __init__(self, *, population: int, shard_size: int,
                 shift_leaves: list[list[torch.Tensor]] | None,
                 shift_names: list[str], shift_treedef,
                 cursor: np.ndarray, bits: np.ndarray,
                 n_slots: int, path: str | None,
                 placement: FleetPlacement | None = None, lead: int = 0):
        self.population = int(population)
        self.shard_size = int(shard_size)
        self._shift_leaves = shift_leaves  # [leaf][shard] row-block arrays
        self._shift_names = shift_names
        self._shift_treedef = shift_treedef
        self.cursor = cursor  # (C,) int64 micro-steps consumed per client
        self.bits = bits  # (C,) float64 cumulative uplink bits per client
        self.n_slots = int(n_slots)
        self.path = path
        # spread over processes: the owned clients' rows only (row c // P)
        self.placement = placement
        self._lead = lead  # the slot axis before each row's parameter axes

    # -- construction -------------------------------------------------------

    @classmethod
    def create(cls, params, population: int, rule, *, n_slots: int = 1,
               dtype=np.float32, shard_size: int = SHARD_ROWS,
               path: str | None = None,
               placement: FleetPlacement | None = None
               ) -> "ClientStateStore":
        """Zero store shaped for `rule` over `params`-shaped clients.

        `rule` is a `core.rules.ShiftRule`: rules without memory
        (`has_shifts=False`) get a shift-less store (cursors/bits only);
        slotted rules insert the `n_slots` axis after the client axis.
        `params` may be tensors (meta tensors will do) or arrays; `dtype`
        a torch or numpy dtype. `path` makes every shard an `np.memmap`
        under that directory. With `placement` the store is one
        process's: `params` its shards of the parameters, its rows those
        of the clients it owns.
        """
        if population < 1:
            raise ValueError(f"population={population}")
        if shard_size < 1:
            raise ValueError(f"shard_size={shard_size}")
        dt = stored_dtype(dtype)
        names, leaves, treedef = _leaf_paths(params)
        shift_leaves = None
        # a spread store's own files (and write probe): `.p{rank}`
        tag = "" if placement is None else f".p{placement.comm.rank}"
        if rule.has_shifts:
            lead = (n_slots,) if rule.slotted else ()
            if path is not None:
                # fail fast with a readable error instead of deep inside
                # np.memmap when the path is unwritable (read-only mount,
                # permission hole, a FILE where the dir should be, ...)
                try:
                    os.makedirs(path, exist_ok=True)
                    probe = os.path.join(path, ".write_probe" + tag)
                    with open(probe, "wb"):
                        pass
                    os.unlink(probe)
                except OSError as e:
                    raise OSError(
                        f"store path {path!r} is not a writable directory "
                        f"({e}) — pass a location the fleet driver can "
                        "memmap shift shards under") from e
            shift_leaves = []
            held = (population if placement is None
                    else len(placement.owned(0, population)))
            for name, leaf in zip(names, leaves):
                shards = []
                for s, rows in _shard_rows(held, shard_size):
                    shape = (rows,) + lead + tuple(leaf.shape)
                    if path is None:
                        shards.append(dt.tensor(np.zeros(shape, dt.storage)))
                    else:
                        fn = os.path.join(
                            path, f"{name.replace('/', '.')}.{s}{tag}.dat")
                        shards.append(dt.tensor(np.memmap(
                            fn, dtype=dt.storage, mode="w+", shape=shape)))
                shift_leaves.append(shards)
        return cls(population=population, shard_size=shard_size,
                   shift_leaves=shift_leaves, shift_names=names,
                   shift_treedef=treedef,
                   cursor=np.zeros((population,), np.int64),
                   bits=np.zeros((population,), np.float64),
                   n_slots=n_slots, path=path, placement=placement,
                   lead=1 if rule.slotted else 0)

    @staticmethod
    def estimate_nbytes(params, population: int, rule, *, n_slots: int = 1,
                        dtype=np.float32) -> int:
        """Host bytes a `create` call would back (without allocating) —
        the dry-run's fleet sizing number."""
        if not rule.has_shifts:
            return population * (8 + 8)  # cursors + bit counters
        slot = n_slots if rule.slotted else 1
        per_client = sum(
            int(np.prod(l.shape)) for l in tree_leaves(params)
        ) * slot * stored_dtype(dtype).itemsize
        return population * (per_client + 8 + 8)

    @property
    def has_shifts(self) -> bool:
        return self._shift_leaves is not None

    @property
    def row_nbytes(self) -> int:
        """One client's row over every shift leaf, as this store holds it
        (spread: its model shards' slices)."""
        if not self.has_shifts:
            return 0
        return sum(shards[0][0].numel() * shards[0].element_size()
                   for shards in self._shift_leaves)

    @property
    def num_shards(self) -> int:
        return -(-self.population // self.shard_size)

    def spec(self) -> dict:
        """JSON-serializable layout description (checkpoint validation)."""
        return {"population": self.population,
                "shard_size": self.shard_size, "n_slots": self.n_slots,
                "leaves": list(self._shift_names) if self.has_shifts else []}

    # -- sharded row access --------------------------------------------------

    def _check_cohort(self, cohort: np.ndarray) -> np.ndarray:
        cohort = np.asarray(cohort, np.int64)
        if cohort.ndim != 1:
            raise ValueError(f"cohort must be a 1-D id vector, got shape "
                             f"{cohort.shape}")
        # full-vector bounds check BEFORE sortedness: an unsorted cohort
        # with out-of-range ids must get the bounds error (naming the bad
        # ids), not a misleading "strictly increasing" complaint
        oob = cohort[(cohort < 0) | (cohort >= self.population)]
        if oob.size:
            shown = ", ".join(str(c) for c in oob[:8])
            more = f" (+{oob.size - 8} more)" if oob.size > 8 else ""
            raise ValueError(
                f"cohort ids outside [0, {self.population}): "
                f"[{shown}]{more}")
        if np.any(np.diff(cohort) <= 0):
            raise ValueError(
                "cohort must be strictly increasing — sorted, distinct ids "
                "(the canonical CohortSampler order); duplicates would make "
                "scatter ill-defined")
        return cohort

    def _take(self, shards: list[torch.Tensor],
              idx: np.ndarray) -> torch.Tensor:
        """The rows `idx` in one new tensor, pinned where a card is present
        (a gathered slice exists to be copied there)."""
        out = torch.empty((idx.size,) + tuple(shards[0].shape[1:]),
                          dtype=shards[0].dtype,
                          pin_memory=torch.cuda.is_available())
        sid = idx // self.shard_size
        for s in np.unique(sid):
            sel = np.flatnonzero(sid == s)
            rows = torch.from_numpy(idx[sel] - s * self.shard_size)
            if sel.size == idx.size:  # one shard holds the whole cohort
                torch.index_select(shards[s], 0, rows, out=out)
            else:
                out[torch.from_numpy(sel)] = shards[s][rows]
        return out

    def _put(self, shards: list[torch.Tensor], idx: np.ndarray,
             values: torch.Tensor) -> None:
        sid = idx // self.shard_size
        for s in np.unique(sid):
            sel = np.flatnonzero(sid == s)
            rows = torch.from_numpy(idx[sel] - s * self.shard_size)
            part = (values if sel.size == idx.size
                    else values[torch.from_numpy(sel)])
            shards[s].index_copy_(0, rows, part)

    # -- the gather/scatter contract ------------------------------------------

    def gather(self, cohort: np.ndarray):
        """Cohort shift slices: a tree of host tensors `(m, [n_slots,]
        *param)` in the store dtype — exactly the client-stacked layout
        `TrainState.shifts` / `FedState.shifts` hold for resident clients.
        None for memory-free rules."""
        if not self.has_shifts:
            return None
        cohort = self._check_cohort(cohort)
        if self.placement is not None:
            return self._shift_treedef(self._gather_spread(cohort))
        leaves = [self._take(shards, cohort)
                  for shards in self._shift_leaves]
        return self._shift_treedef(leaves)

    def scatter(self, cohort: np.ndarray, updated, done=None) -> None:
        """Write a round's updated cohort slices back (inverse of gather).
        Accepts tensors on any device (each leaf is fetched to the host
        once) or numpy leaves; dtype must round-trip losslessly (the wire
        keeps tables in the store's `shift_dtype`). `done`, an (m,) bool
        mask of the cohort, writes back only those clients' rows.

        Spread over processes, `cohort` is the round's whole cohort and
        `updated` the rows of the client ranks the process serves: each
        goes to its client's owner."""
        if not self.has_shifts:
            if updated is not None:
                raise ValueError("store holds no shifts (memory-free rule) "
                                 "but scatter got a value")
            return
        cohort = self._check_cohort(cohort)
        _, leaves, _ = _leaf_paths(updated)
        if len(leaves) != len(self._shift_leaves):
            raise ValueError(
                f"scatter tree has {len(leaves)} leaves, store holds "
                f"{len(self._shift_leaves)}")
        done = (np.ones(cohort.size, bool) if done is None
                else np.asarray(done, bool))
        if self.placement is not None:
            self._scatter_spread(cohort, leaves, done)
            return
        keep = None if done.all() else torch.from_numpy(np.flatnonzero(done))
        for shards, leaf in zip(self._shift_leaves, leaves):
            arr = host_copy(leaf)
            want = (cohort.size,) + tuple(shards[0].shape[1:])
            if tuple(arr.shape) != want:
                raise ValueError(f"scatter leaf shape {tuple(arr.shape)} != "
                                 f"cohort slice {want}")
            if keep is not None:
                arr = arr[keep]
            self._put(shards, cohort[done], arr.to(shards[0].dtype))

    # -- over processes (a FleetPlacement) ----------------------------------

    def _served(self) -> range:
        """The client ranks the process serves."""
        sl = self.placement.slots
        return range(sl.start, sl.stop)

    def _gather_spread(self, cohort: np.ndarray) -> list:
        pl = self.placement
        served = self._served()
        lo = served.start
        mine = [i for i in served if pl.owner(cohort[i]) == pl.me]
        away = [i for i in range(cohort.size)
                if pl.owner(cohort[i]) == pl.me and pl.server(i) != pl.me]
        out, sends, recvs = [], [], []
        for k, shards in enumerate(self._shift_leaves):
            rows = torch.empty((len(served),) + tuple(shards[0].shape[1:]),
                               dtype=shards[0].dtype,
                               pin_memory=torch.cuda.is_available())
            if mine:
                rows[torch.tensor(mine) - lo] = self._take(
                    shards, pl.row(cohort[mine]))
            if away:
                held = self._take(shards, pl.row(cohort[away]))
                sends += [(pl.peer(pl.server(i)), held[j], _tag(k, i))
                          for j, i in enumerate(away)]
            recvs += [(pl.peer(pl.owner(cohort[i])), rows[i - lo], _tag(k, i))
                      for i in served if pl.owner(cohort[i]) != pl.me]
            out.append(rows)
        pl.comm.exchange(sends, recvs, key=_FLEET)
        return out

    def _scatter_spread(self, cohort: np.ndarray, leaves: list,
                        done: np.ndarray) -> None:
        pl = self.placement
        served = self._served()
        lo = served.start
        mine = [i for i in served if done[i]
                and pl.owner(cohort[i]) == pl.me]
        back = [i for i in range(cohort.size) if done[i]
                and pl.owner(cohort[i]) == pl.me and pl.server(i) != pl.me]
        sends, recvs, puts = [], [], []
        for k, (shards, leaf) in enumerate(zip(self._shift_leaves, leaves)):
            arr = host_copy(leaf)
            want = (len(served),) + tuple(shards[0].shape[1:])
            if tuple(arr.shape) != want:
                raise ValueError(f"scatter leaf shape {tuple(arr.shape)} != "
                                 f"the served ranks' slice {want}")
            arr = arr.to(shards[0].dtype)
            if mine:
                self._put(shards, pl.row(cohort[mine]),
                          arr[torch.tensor(mine) - lo])
            sends += [(pl.peer(pl.owner(cohort[i])), arr[i - lo], _tag(k, i))
                      for i in served if done[i]
                      and pl.owner(cohort[i]) != pl.me]
            if back:
                got = torch.empty((len(back),) + want[1:], dtype=arr.dtype)
                recvs += [(pl.peer(pl.server(i)), got[j], _tag(k, i))
                          for j, i in enumerate(back)]
                puts.append((shards, got))
        pl.comm.exchange(sends, recvs, key=_FLEET)
        for shards, got in puts:
            self._put(shards, pl.row(cohort[back]), got)

    def touch(self, cohort: np.ndarray) -> int:
        """Warm the cohort's shift rows (the lookahead pager's prefetch
        hint, DESIGN.md §3.11): reads and discards them so memmap-backed
        shards fault their pages in off the critical path. Returns bytes
        touched; no-op for memory-free rules."""
        if not self.has_shifts:
            return 0
        cohort = self._check_cohort(cohort)
        if self.placement is not None:  # the owner warms its rows
            pl = self.placement
            cohort = pl.row(cohort[[pl.owner(c) == pl.me for c in cohort]])
        n = 0
        for shards in self._shift_leaves:
            n += self._take(shards, cohort).nbytes
        return n

    # -- cursors / accounting --------------------------------------------------

    def cursors(self, cohort: np.ndarray) -> np.ndarray:
        """(m,) per-client micro-step cursors for the cohort."""
        return self.cursor[self._check_cohort(cohort)].copy()

    def advance(self, cohort: np.ndarray, micro_steps: int) -> None:
        """Advance the cohort's data cursors after a round."""
        self.cursor[self._check_cohort(cohort)] += int(micro_steps)

    def add_bits(self, cohort: np.ndarray, bits_per_client: float) -> None:
        """Charge a round's uplink bits to the participating clients."""
        # host-side float64 counters (53-bit mantissa): the f32 stall
        # api.accumulate_bits guards against cannot happen here
        # analysis: allow[bits-accounting] host float64 counters: the f32 stall
        # cannot happen here
        self.bits[self._check_cohort(cohort)] += float(bits_per_client)

    # -- checkpointing ----------------------------------------------------------

    def as_tree(self) -> dict:
        """The store as a plain tree of host arrays (numpy cursors and bits,
        tensor shift shards; per-shard, no concatenation) for
        `checkpoint.save_pytree`. Shapes are a pure
        function of `spec()`, so a fresh `create` + `load_tree` restores."""
        tree: dict[str, Any] = {"cursor": self.cursor, "bits": self.bits}
        if self.has_shifts:
            tree["shifts"] = {
                name: (list(shards) if self.placement is None
                       else [self._take(shards, self._owned_rows(s))
                             for s, _ in _shard_rows(self.population,
                                                     self.shard_size)])
                for name, shards in zip(self._shift_names,
                                        self._shift_leaves)}
        return tree

    def _owned_rows(self, s: int) -> np.ndarray:
        """The store rows of the clients this process owns in population
        shard s."""
        lo = s * self.shard_size
        hi = min(lo + self.shard_size, self.population)
        return self.placement.row(np.asarray(self.placement.owned(lo, hi)))

    def checkpoint_parts(self):
        """How `as_tree()`'s leaves spread over processes, for a
        checkpoint (`checkpoint.io.save_fleet_checkpoint`): a
        `StoreShards`, or None on one process."""
        return None if self.placement is None else StoreShards(self)

    def load_tree(self, tree: dict) -> None:
        """Restore `as_tree()` output in place (shapes/dtypes must match —
        build the store with the run's own `create` first)."""
        self.cursor[...] = np.asarray(tree["cursor"], np.int64)
        self.bits[...] = np.asarray(tree["bits"], np.float64)
        if not self.has_shifts:
            return
        shifts = tree["shifts"]
        if self.placement is not None:
            for name, shards in zip(self._shift_names, self._shift_leaves):
                for s, part in enumerate(shifts[name]):
                    self._put(shards, self._owned_rows(s),
                              host_copy(part).to(shards[0].dtype))
            return
        for name, shards in zip(self._shift_names, self._shift_leaves):
            loaded = shifts[name]
            if len(loaded) != len(shards):
                raise ValueError(
                    f"{name}: checkpoint has {len(loaded)} shards, store "
                    f"{len(shards)} — population/shard_size mismatch")
            for dst, src in zip(shards, loaded):
                arr = host_copy(src)
                if arr.shape != dst.shape:
                    raise ValueError(f"{name}: shard shape "
                                     f"{tuple(arr.shape)} != "
                                     f"{tuple(dst.shape)}")
                dst.copy_(arr.to(dst.dtype))


def checkpoint_shard_size(params, population: int, rule, *,
                          n_slots: int = 1, dtype=np.float32) -> int:
    """SHARD_ROWS rows a store shard, unless a shard of the population's rows
    would hold a leaf too large for one checkpoint buffer (msgpack's
    bin32: under 2^32 bytes); then as many rows as fit (at least one).
    `params` are the whole parameters (meta tensors will do). So a full
    width model's shifts (0.82 GB a row for stablelm-1.6b's embedding)
    take a few rows a shard, and every store the format could write
    keeps its layout."""
    if not rule.has_shifts:
        return SHARD_ROWS
    slot = n_slots if rule.slotted else 1
    row = max(int(np.prod(l.shape)) for l in tree_leaves(params)) * slot \
        * stored_dtype(dtype).itemsize
    if min(population, SHARD_ROWS) * row < 2**32:
        return SHARD_ROWS
    return max(1, (2**32 - 1) // row)


def _tag(leaf: int, rank: int) -> int:
    """The message tag of a leaf's row of client rank `rank`: a pair of
    processes matches its messages by it."""
    return leaf * 65_536 + rank


class _Part:
    """An `as_tree()` leaf of a spread store: population shard s of shift
    leaf k (k None: the cursors or the bit counters, the same on every
    process)."""

    __slots__ = ("k", "s")

    def __init__(self, k, s=None):
        self.k, self.s = k, s


class StoreShards:
    """A spread `ClientStateStore` as `checkpoint.io` writes and reads it
    (the counterpart of `launch.sharding.StateShards`): each shift leaf's
    population shard whole on the writer (process 0), every owner's rows
    in client order and every split leaf's model shards put together,
    byte for byte the one-process store's; reading, each process keeps
    its own clients' rows and its shards. Indexed by `as_tree()`'s leaves
    in `tree_flatten` order."""

    def __init__(self, store: ClientStateStore):
        self.store = store
        pl = store.placement
        self.comm, self.pl = pl.comm, pl
        tree: dict[str, Any] = {"cursor": _Part(None), "bits": _Part(None)}
        if store.has_shifts:
            tree["shifts"] = {
                name: [_Part(k, s) for s, _ in _shard_rows(
                    store.population, store.shard_size)]
                for k, name in enumerate(store._shift_names)}
        self.parts = tree_flatten(tree)[0]
        self.writes = self.comm.rank == 0
        # staged through the card where the backend moves device tensors
        self.stage = (None if self.comm.host_staged
                      else torch.device("cuda", torch.cuda.current_device()))

    def _axis(self, k: int):
        """Shift leaf k's split axis in an `as_tree()` leaf (rows first,
        then the slots), or None."""
        ax = None if self.pl.axes is None else self.pl.axes[k]
        if ax is None or self.pl.layout.model_procs == 1:
            return None
        return 1 + self.store._lead + ax

    def _span(self, s: int) -> tuple[int, int]:
        lo = s * self.store.shard_size
        return lo, min(lo + self.store.shard_size, self.store.population)

    def full_shape(self, i: int, shape: list) -> list:
        part = self.parts[i]
        if part.k is None:
            return shape
        shape = list(shape)
        lo, hi = self._span(part.s)
        shape[0] = hi - lo
        ax = self._axis(part.k)
        if ax is not None:
            shape[ax] *= self.pl.layout.model_procs
        return shape

    def gather(self, i: int, leaf):
        """Part i whole on the writer (None elsewhere): the model group's
        shards put together on its first process, then the rows of every
        owner, each padded to the most any owner holds, gathered over
        "fleet" on the writer and put in client order."""
        part, comm, pl = self.parts[i], self.comm, self.pl
        if part.k is None:
            return leaf
        ax = self._axis(part.k)
        if self.stage is not None:
            leaf = leaf.to(self.stage)
        if ax is not None:
            every = comm.gather(leaf.unsqueeze(0), "model", pl.pods,
                                to_first=True)
            if every is None:
                return None
            leaf = torch.cat(list(every.unbind(0)), dim=ax)
        if comm.rank % pl.layout.model_procs:
            return None
        lo, hi = self._span(part.s)
        most = -(-(hi - lo) // pl.procs)
        if leaf.shape[0] < most:
            leaf = torch.cat([leaf, leaf.new_zeros(
                (most - leaf.shape[0],) + tuple(leaf.shape[1:]))])
        every = comm.gather(leaf, _FLEET, pl.pods, to_first=True)
        if every is None:
            return None
        every = every.cpu().unflatten(0, (pl.procs, most))
        c = np.arange(lo, hi)
        q = c % pl.procs
        first = lo + (q - lo) % pl.procs
        return every[torch.from_numpy(q), torch.from_numpy((c - first)
                                                           // pl.procs)]

    def local(self, i: int, arr):
        """This process's part i of the whole part read from a file: its
        clients' rows in the population shard, its model shards."""
        part, pl = self.parts[i], self.pl
        if part.k is None:
            return arr
        lo, hi = self._span(part.s)
        arr = arr[np.asarray(pl.owned(lo, hi), np.int64) - lo]
        ax = self._axis(part.k)
        if ax is not None:
            shards = pl.layout.local_shards
            n = arr.shape[ax] // pl.model
            index = [slice(None)] * arr.ndim
            index[ax] = slice(shards.start * n, shards.stop * n)
            arr = arr[tuple(index)]
        return arr


def host_copy(leaf) -> torch.Tensor:
    """A tensor (any device) or array as a host tensor: one copy of a CUDA
    tensor, into pinned memory."""
    if isinstance(leaf, torch.Tensor):
        if not leaf.is_cuda:
            return leaf.detach()
        out = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
        return out.copy_(leaf.detach())
    return host_tensor(leaf)


def _shard_rows(population: int, shard_size: int):
    """Yield (shard_index, rows_in_shard)."""
    for s in range(-(-population // shard_size)):
        lo = s * shard_size
        yield s, min(shard_size, population - lo)
