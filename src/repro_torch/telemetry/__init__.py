"""Structured metrics, round-phase tracing, and a zero-cost-when-off event
pipeline for train/fleet/wire (port of `repro.telemetry`; DESIGN.md §3.14).

    from repro_torch import telemetry

    with telemetry.session(telemetry.MetricsSink("run.telemetry.jsonl")):
        ...   # drivers/streams/pager/checkpoint emit spans + counters

    python -m repro_torch.telemetry run.telemetry.jsonl --validate --to-trace t.json

Instrumented code calls the module-level `span`/`counter`/`round_metrics`
helpers; with no sink installed they cost one global load and a None
check. The records and traces are byte-equal to the reference's for the
same events; CUDA tensor values are staged for the writer thread
(`stage`), never read on the dispatch thread.
"""
from repro_torch.telemetry.events import (
    EVENT_KINDS,
    SCHEMA_VERSION,
    TelemetryError,
    read_events,
    validate_events,
)
from repro_torch.telemetry.sink import (
    ConsoleReporter,
    MetricsSink,
    Staged,
    active,
    counter,
    enabled,
    install,
    round_metrics,
    run_meta,
    session,
    span,
    stage,
    uninstall,
)
from repro_torch.telemetry.trace import to_trace_events, write_trace

__all__ = [
    "EVENT_KINDS", "SCHEMA_VERSION", "TelemetryError",
    "read_events", "validate_events",
    "ConsoleReporter", "MetricsSink", "Staged", "stage",
    "active", "counter", "enabled", "install", "round_metrics", "run_meta",
    "session", "span", "uninstall",
    "to_trace_events", "write_trace",
]
