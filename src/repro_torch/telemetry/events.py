"""Event schema + JSONL decode for `repro_torch.telemetry` (a copy of
`repro.telemetry.events`; DESIGN.md §3.14).

One run = one append-only JSONL file. Every line is a self-describing,
schema-versioned record (`"v"`), one of four kinds:

  run_meta       static run facts, emitted once near the start: the CLI
                 config, arch/param counts, and the analytic per-level
                 wire accounting (`wire_bytes_per_round`) — so a telemetry
                 file is interpretable without the run's argv;
  round_metrics  the per-round metrics dict (loss, grad_norm, the fleet
                 participation keys, opt-in device-side norms);
  span           one host-side phase interval: `ts` (start, seconds since
                 the sink's monotonic epoch), `dur`, `tid` (thread), and
                 `depth` (per-thread nesting level);
  counter        a named domain measurement (uplink bits, chaos events,
                 pager residency); `value` is a number or a small list of
                 numbers (histogram buckets).

Decoding tolerates a TORN TAIL exactly like `checkpoint/io.py` tolerates a
truncated checkpoint read: a crash mid-write can only damage the final
line, so `read_events` drops an undecodable last line silently but raises
`TelemetryError` on damage anywhere else (that is out-of-band corruption,
not an interrupted run).
"""
from __future__ import annotations

import json
import numbers

SCHEMA_VERSION = 1
EVENT_KINDS = ("run_meta", "round_metrics", "span", "counter")


class TelemetryError(RuntimeError):
    """The file is not a readable telemetry stream (corrupt beyond the
    tolerated torn tail, or records violate the schema)."""


def read_events(path: str) -> list[dict]:
    """Decode a telemetry JSONL file; the inverse of the sink's writes.

    An undecodable FINAL line (torn by a crash mid-write) is dropped; an
    undecodable interior line raises `TelemetryError`.
    """
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    while lines and not lines[-1].strip():
        lines.pop()
    events: list[dict] = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            ev = json.loads(line)
        except ValueError as e:
            if i == len(lines) - 1:
                break  # torn tail: the interrupted run's final write
            raise TelemetryError(
                f"{path}: line {i + 1} is not valid JSON mid-file — the "
                f"stream is corrupt beyond a torn tail "
                f"({type(e).__name__}: {e})") from e
        if not isinstance(ev, dict):
            raise TelemetryError(
                f"{path}: line {i + 1} decodes to {type(ev).__name__}, "
                "not an event object")
        events.append(ev)
    return events


def _is_num(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


def _is_metric_value(v) -> bool:
    """round_metrics values: scalars (bool allowed — e.g. `skipped`) or a
    small list of numbers (histograms ride counters, but keep symmetric)."""
    if isinstance(v, (bool, str)) or v is None or _is_num(v):
        return True
    return isinstance(v, list) and all(_is_num(x) for x in v)


def validate_events(events: list[dict]) -> list[str]:
    """Schema check; returns a list of human-readable problems (empty =
    valid). The CI telemetry smoke gates on this."""
    problems: list[str] = []

    def bad(i: int, ev: dict, why: str) -> None:
        problems.append(f"event {i} ({ev.get('kind', '?')}): {why}")

    for i, ev in enumerate(events):
        if ev.get("v") != SCHEMA_VERSION:
            bad(i, ev, f"schema version {ev.get('v')!r} != {SCHEMA_VERSION}")
            continue
        kind = ev.get("kind")
        if kind not in EVENT_KINDS:
            bad(i, ev, f"unknown kind {kind!r}")
            continue
        if not _is_num(ev.get("ts")) or ev["ts"] < 0:
            bad(i, ev, f"ts {ev.get('ts')!r} is not a non-negative number")
        if kind == "run_meta":
            if not isinstance(ev.get("meta"), dict):
                bad(i, ev, "meta is not an object")
        elif kind == "round_metrics":
            if not isinstance(ev.get("round"), int):
                bad(i, ev, f"round {ev.get('round')!r} is not an int")
            metrics = ev.get("metrics")
            if not isinstance(metrics, dict):
                bad(i, ev, "metrics is not an object")
            else:
                for k, v in metrics.items():
                    if not _is_metric_value(v):
                        bad(i, ev, f"metric {k!r} value {v!r} is not a "
                                   "scalar or list of numbers")
        elif kind == "span":
            if not isinstance(ev.get("name"), str):
                bad(i, ev, "span has no name")
            if not _is_num(ev.get("dur")) or ev["dur"] < 0:
                bad(i, ev, f"dur {ev.get('dur')!r} is not a non-negative "
                           "number")
            if not isinstance(ev.get("tid"), int):
                bad(i, ev, "tid is not an int")
            if not isinstance(ev.get("depth"), int) or ev["depth"] < 0:
                bad(i, ev, "depth is not a non-negative int")
        elif kind == "counter":
            if not isinstance(ev.get("name"), str):
                bad(i, ev, "counter has no name")
            v = ev.get("value")
            if not (_is_num(v)
                    or (isinstance(v, list) and all(_is_num(x) for x in v))):
                bad(i, ev, f"value {v!r} is not a number or list of numbers")
            if "round" in ev and not isinstance(ev["round"], int):
                bad(i, ev, f"round {ev['round']!r} is not an int")
    return problems
