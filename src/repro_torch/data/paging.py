"""Out-of-core fleet data: on-disk per-client datasets + deterministic
lookahead paging (port of `repro.data.paging`; DESIGN.md §3.11).

The on-disk layout is the reference's (`{leaf}.{shard}.dat` memmaps and
`data_store.json`), so each package opens the other's stores; pages and
rows come back as CPU tensors (a bf16 leaf is stored as its raw 16 bits,
as the reference's `ml_dtypes` type stores it).

`CohortStream` historically materialized the whole population's datasets as
one host-RAM client-stacked tree — fine at 10^3 clients, fatal at the 10^6+
populations the fleet targets. But the cohort walk is *stateless and pure
in `(seed, round)`* (`CohortSampler.cohort_for_round`), so round t+1's
cohort — and therefore exactly which data rows and which `ClientStateStore`
shift rows it needs — is known while round t's jitted step runs. This
module exploits that:

``ClientDataStore``
    Population datasets on disk as per-client rows, sharded along the
    client axis with the same `shard_size`-row memmap layout discipline as
    `fleet.store.ClientStateStore`: one `{leaf}.{shard}.dat` file per leaf
    per shard plus a `data_store.json` spec. A shard file is created only
    when rows are first written; an absent shard reads as zeros — the
    file-granularity analogue of memmap zero pages, so a `create`d
    population costs no disk until touched. `from_stacked` converts the
    in-RAM client-stacked tree; `open` attaches to an existing layout;
    `spec()` feeds checkpoint-manifest validation so a resume refuses a
    mismatched layout.

``LookaheadPager``
    The deterministic prefetcher: a bounded LRU page cache over
    `(leaf, shard)` pages with an `advance_window(round, cohort_sampler)`
    hook the per-cohort stream calls from its `_PrefetchStream` worker
    thread after assembling round t — it loads exactly the pages rounds
    t+1..t+lookahead will touch, drops resident pages outside that window,
    and (when a store is bound) warms the next cohort's shift rows. The
    pager's `views` expose the identical `views[name][c] -> (n, b, ...)`
    indexing contract `_assemble_rows` already consumes, so paged batches
    are bit-identical to the in-RAM path by construction. `gather`/
    `scatter` delegate to the bound `ClientStateStore` (or its chaos
    `FaultyStore` wrapper), letting the fleet drivers route all paged I/O
    through one object and keep `_io_retry` coverage.

Thread model: the page cache is touched only by whoever assembles batches —
with prefetch enabled that is the single `_PrefetchStream` worker thread,
and exactly one build is ever in flight, so no locking is needed. Stats
reads (`resident_nbytes`, hit/miss counters) from the calling thread are
racy-but-monotonic diagnostics, never correctness inputs.
"""
from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.data.pipeline import host_tensor

_SPEC_FILE = "data_store.json"


class _Dtype:
    """A leaf's element type: its name in the spec (numpy's, "bfloat16"
    for bf16) and the numpy type its bits are stored as on disk."""

    __slots__ = ("name", "storage")

    def __init__(self, name: str):
        self.name = name
        self.storage = np.dtype(np.uint16 if name == "bfloat16" else name)

    @property
    def itemsize(self) -> int:
        return self.storage.itemsize

    def tensor(self, arr: np.ndarray) -> torch.Tensor:
        """Stored bits -> a CPU tensor of this type (no copy)."""
        if self.name == "bfloat16":
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr)

    def bits(self, values) -> np.ndarray:
        """Values of this type (tensor or numpy) -> their stored bits."""
        if isinstance(values, torch.Tensor):
            t = values.detach().cpu()
            if self.name == "bfloat16":
                return t.to(torch.bfloat16).view(torch.int16).numpy().view(
                    np.uint16)
            return t.numpy().astype(self.storage, copy=False)
        arr = np.asarray(values)
        if self.name == "bfloat16":
            return arr.view(np.uint16)
        return arr.astype(self.storage, copy=False)


def stored_dtype(dtype) -> _Dtype:
    """How leaves of a torch or numpy dtype (or a dtype name) are stored."""
    if isinstance(dtype, torch.dtype):
        return _Dtype(str(dtype).removeprefix("torch."))
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return _Dtype(name)


def _probe_writable(path: str) -> None:
    """Fail fast with a readable error instead of deep inside np.memmap when
    the path is unwritable (read-only mount, permission hole, a FILE where
    the dir should be, ...) — same probe as `ClientStateStore.create`."""
    try:
        os.makedirs(path, exist_ok=True)
        probe = os.path.join(path, ".write_probe")
        with open(probe, "wb"):
            pass
        os.unlink(probe)
    except OSError as e:
        raise OSError(
            f"data-store path {path!r} is not a writable directory ({e}) — "
            "pass a location the pager can memmap per-client rows under"
        ) from e


class ClientDataStore:
    """Per-client dataset rows on disk, sharded along the client axis.

    Every leaf holds `(n, b, ...)` rows per client (client c's rows live in
    shard `c // shard_size` at local row `c % shard_size`), mirroring the
    client-stacked `(C, n, b, ...)` tree `normalize_client_data` accepts —
    uniform n only; uneven per-client sizes stay an in-RAM niche. Reads
    come back as materialized numpy copies (one page = one leaf's shard),
    so resident memory is whatever the caller keeps, not mmap guesswork.
    """

    def __init__(self, *, path: str, population: int, shard_size: int,
                 leaves: dict[str, tuple[tuple[int, ...], _Dtype]],
                 writable: bool):
        self.path = path
        self.population = int(population)
        self.shard_size = int(shard_size)
        self._leaves = dict(leaves)  # name -> (per-client shape, dtype)
        self._writable = bool(writable)

    # -- construction -------------------------------------------------------

    @classmethod
    def create(cls, path: str, population: int,
               leaf_structs: Mapping[str, Any], *,
               shard_size: int = 4096) -> "ClientDataStore":
        """Lay out an (all-zeros) population store under `path`.

        `leaf_structs` maps leaf name -> array or tensor (a meta tensor
        will do) whose shape is ONE client's rows `(n, b, ...)`. No shard files are
        written — absent shards read as zeros — so a 10^6-client store
        costs a spec file until rows arrive via `write_rows`.
        """
        if population < 1:
            raise ValueError(f"population={population}")
        if shard_size < 1:
            raise ValueError(f"shard_size={shard_size}")
        if not leaf_structs:
            raise ValueError("leaf_structs must be a non-empty mapping")
        leaves = {}
        for name, s in leaf_structs.items():
            shape = tuple(int(d) for d in s.shape)
            if len(shape) < 2:
                raise ValueError(
                    f"leaf {name!r}: per-client rows must be (n, b, ...), "
                    f"got shape {shape}")
            leaves[name] = (shape, stored_dtype(s.dtype))
        _probe_writable(path)
        spec = {"version": 1, "population": int(population),
                "shard_size": int(shard_size),
                "leaves": {name: {"shape": list(shape), "dtype": dt.name}
                           for name, (shape, dt) in leaves.items()}}
        tmp = os.path.join(path, _SPEC_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(spec, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(path, _SPEC_FILE))
        return cls(path=path, population=population, shard_size=shard_size,
                   leaves=leaves, writable=True)

    @classmethod
    def from_stacked(cls, path: str, data: Mapping[str, Any], *,
                     shard_size: int = 4096) -> "ClientDataStore":
        """Convert an in-RAM client-stacked tree (`{name: (C, n, b, ...)}`,
        the exact thing `CohortStream(data=...)` takes) into an on-disk
        store. Uniform per-client n only."""
        if not isinstance(data, Mapping) or not data:
            raise ValueError("data must be a non-empty mapping of named "
                             "client-stacked (C, n, b, ...) leaves")
        arrays = {}
        pop = None
        for name, leaf in data.items():
            arr = host_tensor(leaf)
            if arr.ndim < 3:
                raise ValueError(
                    f"leaf {name!r}: expected client-stacked (C, n, b, ...) "
                    f"rows, got shape {tuple(arr.shape)}")
            if pop is None:
                pop = arr.shape[0]
            elif arr.shape[0] != pop:
                raise ValueError(
                    f"leaf {name!r} holds {arr.shape[0]} clients, "
                    f"others hold {pop}")
            arrays[name] = arr
        structs = {name: arr[0] for name, arr in arrays.items()}
        store = cls.create(path, pop, structs, shard_size=shard_size)
        store.write_rows(np.arange(pop, dtype=np.int64), arrays)
        return store

    @classmethod
    def open(cls, path: str, *, mode: str = "r") -> "ClientDataStore":
        """Attach to an existing layout. mode 'r' (read-only) or 'r+'."""
        if mode not in ("r", "r+"):
            raise ValueError(f"mode={mode!r}; options: 'r', 'r+'")
        fn = os.path.join(path, _SPEC_FILE)
        try:
            with open(fn) as f:
                spec = json.load(f)
        except OSError as e:
            raise OSError(
                f"{path!r} is not a client data store (no {_SPEC_FILE}: "
                f"{e}) — build one with ClientDataStore.from_stacked/"
                "create first") from e
        leaves = {name: (tuple(l["shape"]), _Dtype(l["dtype"]))
                  for name, l in spec["leaves"].items()}
        return cls(path=path, population=spec["population"],
                   shard_size=spec["shard_size"], leaves=leaves,
                   writable=(mode == "r+"))

    # -- layout --------------------------------------------------------------

    @property
    def leaf_names(self) -> list[str]:
        return list(self._leaves)

    @property
    def num_shards(self) -> int:
        return -(-self.population // self.shard_size)

    @property
    def n_batches(self) -> int:
        """Usable batches per client: min over leaves of their n."""
        return min(shape[0] for shape, _ in self._leaves.values())

    def shard_rows(self, s: int) -> int:
        lo = s * self.shard_size
        if not 0 <= lo < self.population:
            raise IndexError(f"shard {s} outside [0, {self.num_shards})")
        return min(self.shard_size, self.population - lo)

    def page_nbytes(self, name: str) -> int:
        """Bytes of one FULL shard page of `name` (the last shard may be
        smaller)."""
        shape, dt = self._leaves[name]
        return self.shard_size * int(np.prod(shape)) * dt.itemsize

    @staticmethod
    def estimate_nbytes(leaf_structs: Mapping[str, Any],
                        population: int) -> int:
        """Disk bytes a fully-written store would hold (spec file aside) —
        the dry-run's paged-fleet sizing number."""
        return population * sum(
            int(np.prod(s.shape)) * stored_dtype(s.dtype).itemsize
            for s in leaf_structs.values())

    @property
    def nbytes(self) -> int:
        """Fully-written size of THIS store's layout."""
        return self.population * sum(
            int(np.prod(shape)) * dt.itemsize
            for shape, dt in self._leaves.values())

    def spec(self) -> dict:
        """JSON-serializable layout description — recorded in fleet
        checkpoints so a resume refuses a mismatched data-store layout."""
        return {"population": self.population,
                "shard_size": self.shard_size,
                "leaves": {name: {"shape": list(shape), "dtype": dt.name}
                           for name, (shape, dt) in self._leaves.items()}}

    # -- pages ---------------------------------------------------------------

    def _shard_path(self, name: str, s: int) -> str:
        return os.path.join(self.path, f"{name.replace('/', '.')}.{s}.dat")

    def page(self, name: str, s: int) -> torch.Tensor:
        """Materialize shard `s` of leaf `name` as a `(rows, n, b, ...)`
        RAM copy (a CPU tensor); absent shard files read as zeros."""
        shape, dt = self._leaves[name]
        rows = self.shard_rows(s)
        fn = self._shard_path(name, s)
        if not os.path.exists(fn):
            return dt.tensor(np.zeros((rows,) + shape, dt.storage))
        mm = np.memmap(fn, dtype=dt.storage, mode="r", shape=(rows,) + shape)
        out = np.array(mm)
        del mm
        return dt.tensor(out)

    def write_rows(self, ids: np.ndarray, values: Mapping[str, Any]) -> None:
        """Write per-client rows: `values[name][i]` becomes client
        `ids[i]`'s rows. Creates shard files on first touch (incremental
        population ingest; `from_stacked` is one call of this)."""
        if not self._writable:
            raise OSError(f"store at {self.path!r} was opened read-only")
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.population):
            raise ValueError(f"client ids outside [0, {self.population})")
        for name, vals in values.items():
            shape, dt = self._leaves[name]
            arr = dt.bits(vals)
            if arr.shape != (ids.size,) + shape:
                raise ValueError(
                    f"leaf {name!r}: rows shape {arr.shape} != "
                    f"{(ids.size,) + shape}")
            sid = ids // self.shard_size
            for s in np.unique(sid):
                rows = self.shard_rows(int(s))
                fn = self._shard_path(name, int(s))
                mode = "r+" if os.path.exists(fn) else "w+"
                mm = np.memmap(fn, dtype=dt.storage, mode=mode,
                               shape=(rows,) + shape)
                sel = sid == s
                mm[ids[sel] - int(s) * self.shard_size] = arr[sel]
                mm.flush()
                del mm


class _PagedLeafView:
    """The `views[name][c] -> (n, b, ...)` indexing contract of
    `normalize_client_data`, backed by the pager's page cache — so
    `_assemble_rows` consumes paged and in-RAM data identically."""

    def __init__(self, pager: "LookaheadPager", name: str):
        self._pager = pager
        self._name = name

    def __getitem__(self, client: int) -> torch.Tensor:
        pager = self._pager
        s, r = divmod(int(client), pager.data.shard_size)
        return pager._page(self._name, s)[r]


class LookaheadPager:
    """Bounded-resident page cache with closed-form cohort lookahead.

    lookahead     rounds of prefetch window (>= 0); `advance_window(t, cs)`
                  keeps exactly the pages rounds t+1..t+lookahead touch and
                  evicts the rest — the steady-state resident set is
                  bounded by `resident_bound_nbytes(cohort_size)`
                  regardless of population;
    max_resident  optional hard page-count cap (LRU eviction) for
                  cold random access outside the windowed walk;
    state         optional `ClientStateStore` (or `FaultyStore` wrapper):
                  `gather`/`scatter` delegate to it so drivers route all
                  paged I/O here, and `advance_window` warms the next
                  cohort's shift rows via `state.touch` (uninjected — a
                  prefetch hint must not perturb the chaos I/O schedule).
    """

    def __init__(self, data: ClientDataStore, *, lookahead: int = 1,
                 max_resident: int | None = None, state=None):
        if lookahead < 0:
            raise ValueError(f"lookahead={lookahead}")
        if max_resident is not None and max_resident < 1:
            raise ValueError(f"max_resident={max_resident}")
        self.data = data
        self.lookahead = int(lookahead)
        self.max_resident = max_resident
        self.state = state
        self._pages: OrderedDict[tuple[str, int], torch.Tensor] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.state_bytes_warmed = 0
        self.views = {name: _PagedLeafView(self, name)
                      for name in data.leaf_names}

    # -- the CohortStream-facing data contract -------------------------------

    @property
    def population(self) -> int:
        return self.data.population

    @property
    def n_batches(self) -> int:
        return self.data.n_batches

    def _page(self, name: str, s: int) -> torch.Tensor:
        key = (name, int(s))
        page = self._pages.get(key)
        if page is not None:
            self._pages.move_to_end(key)
            self.hits += 1
            return page
        self.misses += 1
        page = self.data.page(name, s)
        self._pages[key] = page
        if self.max_resident is not None:
            while len(self._pages) > self.max_resident:
                self._pages.popitem(last=False)
                self.evictions += 1
        return page

    def pages_for_round(self, rnd: int, cohort_sampler,
                        clients: slice = slice(None)) -> set:
        """The `(leaf, shard)` pages round `rnd` will touch — closed form
        via `cohort_for_round`; `clients`: of the cohort's ranks, those
        whose rows this process assembles (all by default)."""
        cohort = cohort_sampler.cohort_for_round(rnd)[clients]
        shards = np.unique(np.asarray(cohort, np.int64) // self.data.shard_size)
        return {(name, int(s)) for name in self.data.leaf_names
                for s in shards}

    def advance_window(self, done_round: int, cohort_sampler,
                       clients: slice = slice(None)) -> None:
        """Called (from the prefetch worker) after round `done_round`'s
        batch is assembled: evict pages outside the lookahead window, then
        load the window's pages so round t+1 assembles from cache while
        round t's step runs. Also warms the next cohort's shift rows on
        the bound store. `clients`: the cohort's ranks this process
        assembles (a spread fleet's own), whose pages alone it loads."""
        with telemetry.span("page_in", round=done_round + 1):
            keep = set()
            for r in range(done_round + 1, done_round + 1 + self.lookahead):
                keep |= self.pages_for_round(r, cohort_sampler, clients)
            for key in [k for k in self._pages if k not in keep]:
                del self._pages[key]
                self.evictions += 1
            for name, s in sorted(keep):
                self._page(name, s)
            if self.state is not None and self.lookahead > 0:
                touch = getattr(self.state, "touch", None)
                if touch is not None:
                    nxt = cohort_sampler.cohort_for_round(done_round + 1)
                    self.state_bytes_warmed += touch(nxt)
        if telemetry.enabled():
            # cumulative residency/hit-rate snapshot after the window move
            for name, v in self.stats().items():
                telemetry.counter(f"pager.{name}", int(v),
                                  round=done_round + 1)

    # -- store I/O routing (drivers call through the pager) ------------------

    def bind_store(self, store) -> None:
        """Late-bind the state store the drivers route gather/scatter
        through — bound AFTER any chaos `FaultyStore` wrap so `_io_retry`
        covers paged reads on the same injection schedule."""
        self.state = store

    def gather(self, cohort):
        if self.state is None:
            raise RuntimeError(
                "pager has no bound ClientStateStore — call bind_store "
                "(the fleet drivers do this) before gather/scatter")
        return self.state.gather(cohort)

    def scatter(self, cohort, updated, done=None):
        if self.state is None:
            raise RuntimeError(
                "pager has no bound ClientStateStore — call bind_store "
                "(the fleet drivers do this) before gather/scatter")
        return self.state.scatter(cohort, updated, done)

    # -- diagnostics ---------------------------------------------------------

    def resident_pages(self) -> int:
        return len(self._pages)

    def resident_nbytes(self) -> int:
        return sum(p.nbytes for p in self._pages.values())

    def resident_bound_nbytes(self, cohort_size: int) -> int:
        """Worst-case steady-state resident bytes for a windowed walk:
        (lookahead + 1) rounds' pages (the round being assembled plus the
        prefetched window), each round touching at most min(num_shards,
        cohort_size) pages per leaf."""
        pages_per_round = min(self.data.num_shards, int(cohort_size))
        per_round = sum(self.data.page_nbytes(name)
                        for name in self.data.leaf_names) * pages_per_round
        return (self.lookahead + 1) * per_round

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "resident_pages": self.resident_pages(),
                "resident_nbytes": self.resident_nbytes(),
                "state_bytes_warmed": self.state_bytes_warmed}
