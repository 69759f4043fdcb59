"""Pytree checkpointing: msgpack-framed, per-leaf raw buffers (port of
`repro.checkpoint.io`).

The file format is the reference's, byte for byte, so each package reads
the other's files: one msgpack map `{"manifest": <json str>, "buffers":
[<bin>, ...]}`, the manifest first, listing each leaf's path (spelled as
the reference's `_tree_paths` spells JAX key paths: `core.api.tree_paths`),
numpy dtype name and shape; bf16 leaves are saved as their raw `u2` bits
and restored bit for bit. Writes are atomic (write-to-temp + `os.replace`).

The port has no `msgpack` package, so it carries an encoder and a decoder
for the subset the reference writes (fixmap/map16, fixstr/str8/16/32,
fixarray/array16/32, bin8/16/32). Both stream: a leaf is fetched from the
device and written, or read and placed on the device, one at a time, so
the host never holds the whole blob the reference builds in memory
(`io.py`:76 there). Truncated or malformed input raises `CheckpointError`.
"""
from __future__ import annotations

import json
import os
import struct
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.api import tree_flatten, tree_paths

_FORMAT_VERSION = 1


class CheckpointError(RuntimeError):
    """The file is not a readable repro checkpoint (truncated, corrupt, or
    a different format). Raised instead of the raw decode traceback so
    callers can tell a bad file from a code bug."""


def _corrupt(path: str, what: str, e: Exception) -> CheckpointError:
    return CheckpointError(
        f"{path}: cannot decode {what} — checkpoint is truncated or corrupt "
        f"({type(e).__name__}: {e})")


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------

def _str_header(n: int) -> bytes:
    if n < 32:
        return bytes([0xA0 | n])
    if n < 1 << 8:
        return b"\xd9" + struct.pack(">B", n)
    if n < 1 << 16:
        return b"\xda" + struct.pack(">H", n)
    return b"\xdb" + struct.pack(">I", n)


def _bin_header(n: int) -> bytes:
    if n < 1 << 8:
        return b"\xc4" + struct.pack(">B", n)
    if n < 1 << 16:
        return b"\xc5" + struct.pack(">H", n)
    if n < 1 << 32:
        return b"\xc6" + struct.pack(">I", n)
    raise ValueError(f"a leaf of {n} bytes exceeds msgpack's bin32 limit")


def _array_header(n: int) -> bytes:
    if n < 16:
        return bytes([0x90 | n])
    if n < 1 << 16:
        return b"\xdc" + struct.pack(">H", n)
    return b"\xdd" + struct.pack(">I", n)


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _str_header(len(raw)) + raw


class _Reader:
    """Decodes the subset from a binary file object; a short read or an
    unknown type byte raises ValueError (wrapped as `CheckpointError`)."""

    def __init__(self, f):
        self._f = f

    def read(self, n: int) -> bytes:
        b = self._f.read(n)
        if len(b) != n:
            raise ValueError(f"unexpected end of data ({len(b)} of {n} "
                             "bytes)")
        return b

    def read_into(self, n: int) -> np.ndarray:
        buf = np.empty(n, np.uint8)
        got = self._f.readinto(memoryview(buf)) if n else 0
        if got != n:
            raise ValueError(f"unexpected end of data ({got} of {n} bytes)")
        return buf

    def _uint(self, fmt: str) -> int:
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))[0]

    def header(self) -> tuple[str, int]:
        """(kind, length) of the next value: "map", "array", "str", "bin"."""
        t = self.read(1)[0]
        if 0x80 <= t <= 0x8F:
            return "map", t & 0x0F
        if 0x90 <= t <= 0x9F:
            return "array", t & 0x0F
        if 0xA0 <= t <= 0xBF:
            return "str", t & 0x1F
        sized = {0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"),
                 0xDB: ("str", ">I"), 0xC4: ("bin", ">B"),
                 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I")}
        if t not in sized:
            raise ValueError(f"msgpack type byte {t:#04x} is not one a "
                             "checkpoint holds")
        kind, fmt = sized[t]
        return kind, self._uint(fmt)

    def string(self) -> str:
        kind, n = self.header()
        if kind != "str":
            raise ValueError(f"expected a str, got a {kind}")
        return self.read(n).decode("utf-8")

    def skip(self) -> None:
        kind, n = self.header()
        if kind in ("str", "bin"):
            self._f.seek(n, os.SEEK_CUR)
            return
        for _ in range(2 * n if kind == "map" else n):
            self.skip()

    def at_end(self) -> bool:
        return self._f.read(1) == b""


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def _host_bytes(leaf) -> np.ndarray:
    """The leaf's raw bytes as a uint8 host array (bf16 as its u2 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.contiguous().cpu().numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.reshape(-1).view(np.uint8)


def _from_buffer(buf: np.ndarray, dtype: str, shape):
    """A decoded buffer (a fresh uint8 array) as a host array of its leaf:
    numpy, or a torch tensor for bf16 (numpy has no bf16)."""
    if dtype == "bfloat16":
        return torch.from_numpy(
            buf.view(np.int16).reshape(shape)).view(torch.bfloat16)
    return buf.view(np.dtype(dtype)).reshape(shape)


def save_pytree(path: str, tree: Any, *, step: int | None = None,
                meta: dict | None = None, shards=None) -> None:
    """`meta`: optional JSON-serializable sidecar stored in the manifest —
    the train loop checkpoints the data-pipeline cursor (epoch, step) and
    sampler spec here so resume bit-reproduces the batch stream. Leaves
    may be tensors on any device or numpy arrays; each is fetched to the
    host and written in turn.

    `shards` (`launch.sharding.StateShards`): the tree is one process's
    share of a state spread over processes. Every process calls; each
    per-rank or per-pod leaf is gathered in rank order and each split
    leaf's model shards are put together along their axis, one leaf at a
    time, and only the writing process writes the file, the one a single
    process holding the whole state would write."""
    with telemetry.span("checkpoint", op="save", path=path):
        paths = tree_paths(tree)
        leaves = tree_flatten(tree)[0]
        if shards is not None and not shards.writes:
            for i, leaf in enumerate(leaves):  # take part in each gather
                shards.gather(i, leaf)
            return
        manifest = {"version": _FORMAT_VERSION, "step": step, "meta": meta,
                    "leaves": []}
        for i, (p, leaf) in enumerate(zip(paths, leaves)):
            shape = list(leaf.shape) if hasattr(leaf, "shape") else []
            if shards is not None:
                shape = shards.full_shape(i, shape)
            manifest["leaves"].append(
                {"path": p, "dtype": _dtype_name(leaf), "shape": shape})
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(b"\x82" + _pack_str("manifest")
                        + _pack_str(json.dumps(manifest))
                        + _pack_str("buffers") + _array_header(len(leaves)))
                for i, leaf in enumerate(leaves):
                    if shards is not None:
                        leaf = shards.gather(i, leaf)
                    raw = _host_bytes(leaf)
                    f.write(_bin_header(raw.nbytes))
                    f.write(memoryview(raw))
                    del raw, leaf
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise


def load_meta(path: str) -> dict:
    """Manifest sidecar only: {"step": ..., "meta": ...} without reading
    any leaf buffer (the manifest is packed first, so this is one small
    read)."""
    try:
        with open(path, "rb") as f:
            r = _Reader(f)
            kind, n = r.header()
            if kind != "map":
                raise ValueError(f"top level is a {kind}, not a map")
            for _ in range(n):
                if r.string() == "manifest":
                    manifest = json.loads(r.string())
                    return {"step": manifest.get("step"),
                            "meta": manifest.get("meta")}
                r.skip()
    except (ValueError, KeyError, TypeError, EOFError) as e:
        raise _corrupt(path, "manifest", e) from e
    raise CheckpointError(
        f"{path}: no manifest entry — not a repro checkpoint")


def _place(arr, like, device):
    """A host array decoded for leaf `like` in `like`'s kind and dtype:
    numpy for a numpy leaf; for a tensor leaf a tensor on `device` (a
    torch device), on `like`'s own device (`device=True`; the host for a
    meta tensor) or on the host (`device=False`)."""
    if not isinstance(like, torch.Tensor):
        a = arr.numpy() if isinstance(arr, torch.Tensor) else arr
        return a.astype(np.dtype(like.dtype), copy=False)
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
    if device is True:
        dev = torch.device("cpu") if like.device.type == "meta" else like.device
    elif device is False:
        dev = torch.device("cpu")
    else:
        dev = torch.device(device)
    return t.to(device=dev, dtype=like.dtype)


def load_pytree(path: str, like: Any, *, device=True, shards=None) -> Any:
    """Restore into the structure (and dtypes) of `like`, whose leaves may
    be tensors (meta tensors too) or numpy arrays; see `_place` for where
    each leaf lands. device=False keeps every leaf on the host — required
    when part of the tree is population-sized host state (the fleet
    client-state store). With `shards` (`launch.sharding.StateShards`)
    `like` is one process's share, and each per-rank or per-pod leaf of
    the file gives its own rows (and each split leaf its own model
    shards): a file any layout wrote resumes at any other."""
    want_paths = tree_paths(like)
    like_leaves, unflatten = tree_flatten(like)
    targets = dict(zip(want_paths, like_leaves))
    index = {p: i for i, p in enumerate(want_paths)}

    def place(arr, p):
        if shards is not None:
            arr = shards.local(index[p], arr)
        return _place(arr, targets[p], device)

    got: dict[str, Any] = {}
    with telemetry.span("checkpoint", op="load", path=path):
        try:
            with open(path, "rb") as f:
                r = _Reader(f)
                kind, n = r.header()
                if kind != "map":
                    raise ValueError(f"top level is a {kind}, not a map")
                manifest, pending = None, None
                for _ in range(n):
                    key = r.string()
                    if key == "manifest":
                        manifest = json.loads(r.string())
                    elif key == "buffers":
                        kind, count = r.header()
                        if kind != "array":
                            raise ValueError(f"buffers is a {kind}")
                        pending = []
                        for i in range(count):
                            k2, nbytes = r.header()
                            if k2 != "bin":
                                raise ValueError(f"buffer {i} is a {k2}")
                            buf = r.read_into(nbytes)
                            if manifest is None:
                                pending.append(buf)  # manifest comes later
                                continue
                            meta = manifest["leaves"][i]
                            if meta["path"] in targets:
                                got[meta["path"]] = place(
                                    _from_buffer(buf, meta["dtype"],
                                                 meta["shape"]),
                                    meta["path"])
                            del buf
                    else:
                        r.skip()
                if not r.at_end():
                    raise ValueError("extra data after the checkpoint map")
                if manifest is None:
                    raise KeyError("manifest")
                for meta, buf in zip(manifest["leaves"], pending or []):
                    if meta["path"] in targets:
                        got[meta["path"]] = place(
                            _from_buffer(buf, meta["dtype"], meta["shape"]),
                            meta["path"])
        except (ValueError, KeyError, TypeError, EOFError) as e:
            raise _corrupt(path, "leaf buffers", e) from e

        out = []
        for p, leaf in zip(want_paths, like_leaves):
            if p not in got:
                raise KeyError(f"checkpoint missing leaf {p!r}")
            arr = got[p]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"{p}: shape {tuple(arr.shape)} != expected "
                    f"{tuple(leaf.shape)}")
            out.append(arr)
        return unflatten(out)


def restore_train_state(path: str, like_state: Any, device=True,
                        shards=None) -> Any:
    """Load onto `device` (the reference's `device_put` onto its target
    shardings): the whole state, or with `shards` this process's share."""
    return load_pytree(path, like_state, device=device, shards=shards)


# ---------------------------------------------------------------------------
# fleet checkpoints: the TrainState + the host client-state store in ONE file
# ---------------------------------------------------------------------------

class _FleetShards:
    """A spread fleet's checkpoint tree {"state", "store"}, leaf by leaf in
    `tree_flatten` order (the state's first): the state's leaves as its
    `StateShards` (or whole) say, the store's as its `StoreShards` (or
    whole) say."""

    def __init__(self, n_state: int, state_shards, store_shards):
        self.n = n_state
        self.state, self.store = state_shards, store_shards
        self.writes = (state_shards.writes if state_shards is not None
                       else store_shards.writes)

    def _which(self, i: int):
        if i < self.n:
            return self.state, i
        return self.store, i - self.n

    def full_shape(self, i: int, shape: list) -> list:
        part, j = self._which(i)
        return shape if part is None else part.full_shape(j, shape)

    def gather(self, i: int, leaf):
        part, j = self._which(i)
        return leaf if part is None else part.gather(j, leaf)

    def local(self, i: int, arr):
        part, j = self._which(i)
        return arr if part is None else part.local(j, arr)


def _fleet_shards(state, store, shards):
    parts = store.checkpoint_parts()
    if shards is None and parts is None:
        return None
    return _FleetShards(len(tree_flatten(state)[0]), shards, parts)


def save_fleet_checkpoint(path: str, state: Any, store, *,
                          step: int | None = None,
                          meta: dict | None = None,
                          data_store=None, shards=None) -> None:
    """One atomic checkpoint of a fleet run: the TrainState, the
    population store (`ClientStateStore.as_tree()` — per-shard arrays, no
    concatenation), and the fleet cursor/sampler specs in the manifest
    meta (`FleetRunner.checkpoint_meta()` under the 'fleet' key) so
    `--resume` can validate + rebuild the walk before touching buffers.

    `data_store`: the paged run's `ClientDataStore` — its layout spec is
    recorded so a resume refuses a mismatched (or missing) data store.

    Spread over processes every process calls, with `shards` its state's
    (`launch.sharding.StateShards`) and a store spread over them
    (`fleet.store.FleetPlacement`): process 0 writes the one-process
    run's file, byte for byte, the state's and every owner's store rows
    put together leaf by leaf."""
    meta = dict(meta or {})
    meta.setdefault("store_spec", store.spec())
    if data_store is not None:
        meta.setdefault("data_store_spec", data_store.spec())
    save_pytree(path, {"state": state, "store": store.as_tree()},
                step=step, meta=meta,
                shards=_fleet_shards(state, store, shards))


def restore_fleet_checkpoint(path: str, like_state: Any, store, *,
                             device=True, data_store=None,
                             shards=None) -> Any:
    """Restore a `save_fleet_checkpoint` file: the TrainState goes onto
    `device` (as `load_pytree` places it), the store (built fresh by the caller with the run's own
    layout) is filled IN PLACE from host memory — population-sized buffers
    never touch the card. Returns the TrainState.

    Pass the resumed run's `data_store` (or None for an in-RAM run): its
    layout is checked against the recorded `data_store_spec` BEFORE any
    buffer is decoded. With `shards` (as `save_fleet_checkpoint` takes
    them) each process keeps its rows and shards of a file any layout
    wrote."""
    saved = (load_meta(path)["meta"] or {}).get("data_store_spec")
    have = None if data_store is None else data_store.spec()
    if saved != have:
        def _describe(spec):
            if spec is None:
                return "in-RAM client-stacked data (no data store)"
            return (f"data store with population {spec['population']}, "
                    f"shard_size {spec['shard_size']}, leaves "
                    f"{sorted(spec['leaves'])}")
        raise CheckpointError(
            f"{path}: checkpoint was written against "
            f"{_describe(saved)} but this run uses {_describe(have)} — "
            "resume with the matching --data-store layout (the paged walk "
            "is only bit-reproducible over the same layout)")
    tree = load_pytree(path, {"state": like_state, "store": store.as_tree()},
                       device=False,
                       shards=_fleet_shards(like_state, store, shards))
    store.load_tree(tree["store"])
    host, unflatten = tree_flatten(tree["state"])
    like = tree_flatten(like_state)[0]
    return unflatten([_place(h, l, device) for h, l in zip(host, like)])
