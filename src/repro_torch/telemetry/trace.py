"""Chrome/Perfetto `trace_event` export for telemetry streams (a copy of
`repro.telemetry.trace`: the same events give the same trace, byte for
byte, process name included).

Spans become complete ("X") events, scalar counters and numeric round
metrics become counter ("C") tracks — load the output in
`chrome://tracing` / https://ui.perfetto.dev. Timestamps are the sink's
monotonic seconds converted to the format's microseconds.
"""
from __future__ import annotations

import json
import numbers

_PID = 1


def to_trace_events(events: list[dict]) -> list[dict]:
    """Convert decoded telemetry events to `trace_event` dicts."""
    out: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": _PID, "ts": 0,
         "args": {"name": "repro.telemetry"}},
    ]
    for ev in events:
        kind = ev.get("kind")
        ts_us = float(ev.get("ts", 0.0)) * 1e6
        if kind == "span":
            args = dict(ev.get("args") or {})
            args["depth"] = ev.get("depth", 0)
            out.append({"ph": "X", "name": ev["name"], "cat": "host",
                        "ts": ts_us, "dur": float(ev["dur"]) * 1e6,
                        "pid": _PID, "tid": ev.get("tid", 0), "args": args})
        elif kind == "counter":
            v = ev.get("value")
            if isinstance(v, numbers.Real) and not isinstance(v, bool):
                out.append({"ph": "C", "name": ev["name"], "ts": ts_us,
                            "pid": _PID, "args": {"value": float(v)}})
        elif kind == "round_metrics":
            for name, v in (ev.get("metrics") or {}).items():
                if isinstance(v, numbers.Real) and not isinstance(v, bool):
                    out.append({"ph": "C", "name": f"metrics/{name}",
                                "ts": ts_us, "pid": _PID,
                                "args": {"value": float(v)}})
        elif kind == "run_meta":
            out.append({"ph": "i", "name": "run_meta", "s": "g",
                        "ts": ts_us, "pid": _PID, "tid": 0,
                        "args": ev.get("meta") or {}})
    return out


def write_trace(events: list[dict], path: str) -> int:
    """Write the Chrome trace JSON; returns the trace event count."""
    trace = {"traceEvents": to_trace_events(events),
             "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])
