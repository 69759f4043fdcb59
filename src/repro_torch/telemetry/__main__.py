"""Telemetry stream CLI: validate, summarize, export Chrome traces.

    python -m repro_torch.telemetry RUN.telemetry.jsonl --validate
    python -m repro_torch.telemetry RUN.telemetry.jsonl --to-trace trace.json
    python -m repro_torch.telemetry RUN.telemetry.jsonl --summary

Exit codes: 0 clean, 1 schema problems (--validate), 2 unreadable file.
"""
from __future__ import annotations

import argparse
import sys
from collections import defaultdict

from repro_torch.telemetry.events import (
    TelemetryError,
    read_events,
    validate_events,
)
from repro_torch.telemetry.trace import write_trace


def _summary(events: list[dict]) -> None:
    kinds = defaultdict(int)
    spans: dict[str, list[float]] = defaultdict(list)
    counters: dict[str, float] = defaultdict(float)
    last_metrics: dict | None = None
    last_round = None
    for ev in events:
        kinds[ev.get("kind", "?")] += 1
        if ev.get("kind") == "span":
            spans[ev["name"]].append(float(ev["dur"]))
        elif ev.get("kind") == "counter":
            v = ev.get("value")
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                counters[ev["name"]] += v
        elif ev.get("kind") == "round_metrics":
            last_metrics, last_round = ev.get("metrics"), ev.get("round")
    print("events: " + ", ".join(f"{k}={n}" for k, n in sorted(kinds.items())))
    for name in sorted(spans):
        d = spans[name]
        print(f"span {name:14s} n={len(d):5d} total={sum(d):8.3f}s "
              f"mean={sum(d) / len(d) * 1e3:8.3f}ms")
    for name in sorted(counters):
        print(f"counter {name:28s} total={counters[name]:.6g}")
    if last_metrics is not None:
        shown = {k: v for k, v in last_metrics.items()
                 if isinstance(v, (int, float))}
        print(f"last round {last_round}: " + ", ".join(
            f"{k}={v:.6g}" for k, v in sorted(shown.items())))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.telemetry")
    ap.add_argument("file", help="telemetry JSONL stream")
    ap.add_argument("--to-trace", metavar="OUT", default=None,
                    help="write Chrome/Perfetto trace_event JSON here")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check every record; exit 1 on problems")
    ap.add_argument("--summary", action="store_true",
                    help="print per-span totals, counter sums, last metrics")
    args = ap.parse_args(argv)

    try:
        events = read_events(args.file)
    except (TelemetryError, OSError) as e:
        print(e, file=sys.stderr)
        return 2

    rc = 0
    if args.validate:
        problems = validate_events(events)
        for p in problems:
            print(f"INVALID: {p}", file=sys.stderr)
        print(f"{args.file}: {len(events)} events, "
              + ("schema OK" if not problems
                 else f"{len(problems)} schema problems"))
        rc = 1 if problems else 0
    if args.summary:
        _summary(events)
    if args.to_trace:
        n = write_trace(events, args.to_trace)
        print(f"wrote {n} trace events -> {args.to_trace}")
    if not (args.validate or args.summary or args.to_trace):
        ap.error("nothing to do: pass --validate, --summary, or --to-trace")
    return rc


if __name__ == "__main__":
    sys.exit(main())
