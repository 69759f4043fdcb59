"""`MetricsSink` + the module-global hook surface (port of
`repro.telemetry.sink`; DESIGN.md §3.14).

Zero-cost-when-off: the hot paths (drivers, streams, pager, checkpoint io)
call the MODULE-LEVEL `span`/`counter`/`round_metrics` helpers, which read
one module global and return immediately (a shared no-op context manager
for spans) when no sink is installed.

No extra device syncs when ON: `round_metrics`/`counter` values may be
CUDA tensors (the step's metrics). Reading one on the host waits for the
device, so the sink never reads them on the calling thread: `stage` copies
each with `non_blocking=True` into pinned host memory and records a
`torch.cuda.Event` beside it (no wait), the record goes onto a queue, and
the BACKGROUND WRITER thread waits on the event and then reads. The
trainer stages its metrics once a step whether or not a sink is installed
(its reporter reads the same copy), so a sink adds no device-to-host copy
and no synchronisation to the dispatch thread. Spans read
`time.perf_counter()` twice and never synchronise, so a span measures host
phase time (dispatch, not device completion) by construction.

Thread model: builds/spans fire from both the round loop and the prefetch
worker, so emission is queue-based (`queue.SimpleQueue`, lock-free put)
and span nesting depth is tracked per-thread.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from contextlib import contextmanager

import numpy as np
import torch

from repro_torch.telemetry.events import SCHEMA_VERSION

_CLOSE = object()
_POLL_S = 50e-6  # how often the writer polls a staged value's event


class Staged:
    """A CUDA tensor on its way to the host: copied with `non_blocking=True`
    into pinned host memory on the dispatch thread, with a `torch.cuda.Event`
    recorded behind the copy on the current stream. Nothing waits until a
    reader asks for the value (`value()`, `float()`, `int()`), which waits
    for that event alone; the writer thread polls it (`value(poll=True)`,
    `Event.query`), so it issues no synchronising call into the driver."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def value(self, poll: bool = False):
        if poll:
            while not self.event.query():
                time.sleep(_POLL_S)
        else:
            self.event.synchronize()
        return self.host.item() if self.host.ndim == 0 else self.host.tolist()

    def __float__(self) -> float:
        return float(self.value())

    def __int__(self) -> int:
        return int(self.value())


def stage(v):
    """Stage every CUDA tensor in `v` (a value, dict, list or tuple) for
    the host without waiting (`Staged`); everything else passes through.
    Idempotent: staged values stay as they are."""
    if isinstance(v, torch.Tensor) and v.is_cuda:
        return Staged(v)
    if isinstance(v, dict):
        return {k: stage(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(stage(x) for x in v)
    return v


def _jsonable(v):
    """Materialize one record value for JSON. Runs on the WRITER thread
    (or at `events()` read time for in-memory sinks): this is where staged
    device values are waited for, off the round loop's critical path."""
    if v is None or isinstance(v, (str, bool, int, float)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, Staged):
        return v.value(poll=True)
    if isinstance(v, torch.Tensor):  # a host tensor
        return v.item() if v.ndim == 0 else v.tolist()
    arr = np.asarray(v)  # numpy scalars and arrays
    return arr.item() if arr.ndim == 0 else arr.tolist()


class _Span:
    """One host phase interval; records (ts, dur, tid, depth) on exit."""

    __slots__ = ("_sink", "_name", "_args", "_t0", "_depth")

    def __init__(self, sink: "MetricsSink", name: str, args: dict):
        self._sink = sink
        self._name = name
        self._args = args

    def __enter__(self):
        tls = self._sink._tls
        self._depth = getattr(tls, "depth", 0)
        tls.depth = self._depth + 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        sink = self._sink
        sink._tls.depth = self._depth
        rec = {"v": SCHEMA_VERSION, "kind": "span",
               "ts": self._t0 - sink._epoch, "dur": t1 - self._t0,
               "name": self._name, "tid": threading.get_ident(),
               "depth": self._depth}
        if self._args:
            rec["args"] = self._args
        sink._emit(rec)
        return False


class MetricsSink:
    """Append-only JSONL event stream with a buffered background writer.

    path=None keeps events in memory (`events()`) — used by tests and the
    census identity check. With a path, a daemon writer thread drains the
    emission queue, materializes values, and flushes every `flush_every`
    records (and at close), so an interrupted run loses at most the torn
    tail `read_events` already tolerates.
    """

    def __init__(self, path: str | None = None, *, flush_every: int = 64):
        self.path = path
        self._epoch = time.perf_counter()
        self._tls = threading.local()
        self._closed = False
        self._mem: list[dict] = []
        self._q: queue.SimpleQueue | None = None
        self._thread: threading.Thread | None = None
        self._file = None
        self._flush_every = max(1, int(flush_every))
        if path is not None:
            self._file = open(path, "w")
            self._q = queue.SimpleQueue()
            self._thread = threading.Thread(
                target=self._drain, name="telemetry-writer", daemon=True)
            self._thread.start()

    # -- emission ----------------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._epoch

    def _emit(self, rec: dict) -> None:
        if self._closed:
            return
        if self._q is not None:
            self._q.put(rec)
        else:
            self._mem.append(rec)  # GIL-atomic append: thread-safe

    def _drain(self) -> None:
        n = 0
        while True:
            rec = self._q.get()
            if rec is _CLOSE:
                break
            self._file.write(json.dumps(_jsonable(rec)) + "\n")
            n += 1
            if n % self._flush_every == 0:
                self._file.flush()
        self._file.flush()

    # -- record constructors ----------------------------------------------

    def run_meta(self, meta: dict) -> None:
        self._emit({"v": SCHEMA_VERSION, "kind": "run_meta",
                    "ts": self._now(), "meta": meta})

    def round_metrics(self, rnd: int, metrics: dict) -> None:
        """Values may be CUDA tensors: staged here without waiting and
        materialized on the writer thread (the no-extra-syncs argument)."""
        self._emit({"v": SCHEMA_VERSION, "kind": "round_metrics",
                    "ts": self._now(), "round": int(rnd),
                    "metrics": stage(dict(metrics))})

    def counter(self, name: str, value, *, round: int | None = None,
                **tags) -> None:
        rec = {"v": SCHEMA_VERSION, "kind": "counter", "ts": self._now(),
               "name": name, "value": stage(value)}
        if round is not None:
            rec["round"] = int(round)
        if tags:
            rec["tags"] = tags
        self._emit(rec)

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    # -- reads / lifecycle -------------------------------------------------

    def events(self) -> list[dict]:
        """Materialized in-memory events (path=None sinks only)."""
        if self.path is not None:
            raise RuntimeError(
                "this sink writes to a file — close() it and use "
                "telemetry.read_events(path)")
        return [_jsonable(r) for r in list(self._mem)]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._q is not None:
            self._q.put(_CLOSE)
            self._thread.join()
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# the module-global hook surface (what instrumented code calls)
# ---------------------------------------------------------------------------

_ACTIVE: MetricsSink | None = None


class _NoopSpan:
    """Shared do-nothing context manager: the telemetry-off span cost is
    one global load, one None check, and returning this singleton."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def install(sink: MetricsSink) -> MetricsSink:
    """Make `sink` the process-wide active sink (returns it)."""
    global _ACTIVE
    _ACTIVE = sink
    return sink


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> MetricsSink | None:
    return _ACTIVE


def enabled() -> bool:
    return _ACTIVE is not None


def span(name: str, **args):
    s = _ACTIVE
    return _NOOP if s is None else s.span(name, **args)


def counter(name: str, value, *, round: int | None = None, **tags) -> None:
    s = _ACTIVE
    if s is not None:
        s.counter(name, value, round=round, **tags)


def round_metrics(rnd: int, metrics: dict) -> None:
    s = _ACTIVE
    if s is not None:
        s.round_metrics(rnd, metrics)


def run_meta(meta: dict) -> None:
    s = _ACTIVE
    if s is not None:
        s.run_meta(meta)


@contextmanager
def session(sink: MetricsSink):
    """install -> yield -> uninstall + close, exception-safe."""
    install(sink)
    try:
        yield sink
    finally:
        uninstall()
        sink.close()


class ConsoleReporter:
    """The train.py round/step reporter. Reading a staged or device metric
    (`float(metrics['loss'])`) waits for it, only on the steps it prints.

    Rates are monotonic (`time.perf_counter`) and measure the stepping
    window only: `start()` is called after checkpoint restore / stream
    construction, and checkpoint writes happen outside the reported window
    — so checkpoint I/O time is never folded into s/round.
    """

    def __init__(self, *, unit: str = "step", log_every: int = 10,
                 total: int | None = None, start: int = 0):
        self.unit = unit
        self.log_every = max(1, int(log_every))
        self.total = total
        self._start = int(start)
        self._t0: float | None = None

    def start(self) -> "ConsoleReporter":
        self._t0 = time.perf_counter()
        return self

    def report(self, t: int, metrics: dict, *, cohort: int | None = None
               ) -> None:
        if self._t0 is None:
            self.start()
        last = self.total is not None and t == self.total - 1
        if t % self.log_every != 0 and not last:
            return
        if metrics.get("skipped"):
            print(f"{self.unit} {t:5d} | skipped (buffer never filled)",
                  flush=True)
            return
        rate = (time.perf_counter() - self._t0) / (t - self._start + 1)
        part = (f" | done {int(metrics['completed'])}/{cohort}"
                if cohort is not None and "completed" in metrics else "")
        print(f"{self.unit} {t:5d} | loss {float(metrics['loss']):8.4f} | "
              f"gnorm {float(metrics['grad_norm']):9.3f} | "
              f"{rate:6.2f}s/{self.unit}" + part, flush=True)
