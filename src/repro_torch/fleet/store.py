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
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.core.api import tree_flatten, tree_leaves, tree_paths
from repro_torch.data.paging import stored_dtype
from repro_torch.data.pipeline import host_tensor


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
                 n_slots: int, path: str | None):
        self.population = int(population)
        self.shard_size = int(shard_size)
        self._shift_leaves = shift_leaves  # [leaf][shard] row-block arrays
        self._shift_names = shift_names
        self._shift_treedef = shift_treedef
        self.cursor = cursor  # (C,) int64 micro-steps consumed per client
        self.bits = bits  # (C,) float64 cumulative uplink bits per client
        self.n_slots = int(n_slots)
        self.path = path

    # -- construction -------------------------------------------------------

    @classmethod
    def create(cls, params, population: int, rule, *, n_slots: int = 1,
               dtype=np.float32, shard_size: int = 65_536,
               path: str | None = None) -> "ClientStateStore":
        """Zero store shaped for `rule` over `params`-shaped clients.

        `rule` is a `core.rules.ShiftRule`: rules without memory
        (`has_shifts=False`) get a shift-less store (cursors/bits only);
        slotted rules insert the `n_slots` axis after the client axis.
        `params` may be tensors (meta tensors will do) or arrays; `dtype`
        a torch or numpy dtype. `path` makes every shard an `np.memmap`
        under that directory.
        """
        if population < 1:
            raise ValueError(f"population={population}")
        if shard_size < 1:
            raise ValueError(f"shard_size={shard_size}")
        dt = stored_dtype(dtype)
        names, leaves, treedef = _leaf_paths(params)
        shift_leaves = None
        if rule.has_shifts:
            lead = (n_slots,) if rule.slotted else ()
            if path is not None:
                # fail fast with a readable error instead of deep inside
                # np.memmap when the path is unwritable (read-only mount,
                # permission hole, a FILE where the dir should be, ...)
                try:
                    os.makedirs(path, exist_ok=True)
                    probe = os.path.join(path, ".write_probe")
                    with open(probe, "wb"):
                        pass
                    os.unlink(probe)
                except OSError as e:
                    raise OSError(
                        f"store path {path!r} is not a writable directory "
                        f"({e}) — pass a location the fleet driver can "
                        "memmap shift shards under") from e
            shift_leaves = []
            for name, leaf in zip(names, leaves):
                shards = []
                for s, rows in _shard_rows(population, shard_size):
                    shape = (rows,) + lead + tuple(leaf.shape)
                    if path is None:
                        shards.append(dt.tensor(np.zeros(shape, dt.storage)))
                    else:
                        fn = os.path.join(
                            path, f"{name.replace('/', '.')}.{s}.dat")
                        shards.append(dt.tensor(np.memmap(
                            fn, dtype=dt.storage, mode="w+", shape=shape)))
                shift_leaves.append(shards)
        return cls(population=population, shard_size=shard_size,
                   shift_leaves=shift_leaves, shift_names=names,
                   shift_treedef=treedef,
                   cursor=np.zeros((population,), np.int64),
                   bits=np.zeros((population,), np.float64),
                   n_slots=n_slots, path=path)

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
        leaves = [self._take(shards, cohort)
                  for shards in self._shift_leaves]
        return self._shift_treedef(leaves)

    def scatter(self, cohort: np.ndarray, updated) -> None:
        """Write a round's updated cohort slices back (inverse of gather).
        Accepts tensors on any device (each leaf is fetched to the host
        once) or numpy leaves; dtype must round-trip losslessly (the wire
        keeps tables in the store's `shift_dtype`)."""
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
        for shards, leaf in zip(self._shift_leaves, leaves):
            arr = host_copy(leaf)
            want = (cohort.size,) + tuple(shards[0].shape[1:])
            if tuple(arr.shape) != want:
                raise ValueError(f"scatter leaf shape {tuple(arr.shape)} != "
                                 f"cohort slice {want}")
            self._put(shards, cohort, arr.to(shards[0].dtype))

    def touch(self, cohort: np.ndarray) -> int:
        """Warm the cohort's shift rows (the lookahead pager's prefetch
        hint, DESIGN.md §3.11): reads and discards them so memmap-backed
        shards fault their pages in off the critical path. Returns bytes
        touched; no-op for memory-free rules."""
        if not self.has_shifts:
            return 0
        cohort = self._check_cohort(cohort)
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
                name: list(shards)
                for name, shards in zip(self._shift_names,
                                        self._shift_leaves)}
        return tree

    def load_tree(self, tree: dict) -> None:
        """Restore `as_tree()` output in place (shapes/dtypes must match —
        build the store with the run's own `create` first)."""
        self.cursor[...] = np.asarray(tree["cursor"], np.int64)
        self.bits[...] = np.asarray(tree["bits"], np.float64)
        if not self.has_shifts:
            return
        shifts = tree["shifts"]
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
