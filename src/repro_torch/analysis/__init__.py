"""repro_torch.analysis: the port's static invariant checks (the
counterpart of `repro.analysis`).

Two layers, one CLI (``python -m repro_torch.analysis --lint --graph``):

layer 1: AST linter (`lint`, `checkers/`)
    Pure-AST checkers for the port's invariants: generators seeded from
    `core/salts.py` or structured tuples, ignored semantic arguments, bit
    accounting, kernel imports only through the backend, host syncs in the
    steps (what blocks CUDA-graph capture). Imports no torch.

layer 2: the step census (`graph`)
    Runs the real train step on fake tensors (`launch.cost_analysis`) and
    checks what the linter cannot see from source: each wire level's
    message count and bytes against the analytic wire model, no traffic
    where none belongs, dtypes, the in-place shift tables, the elastic
    weights read, and telemetry leaving the ops unchanged.

Importing `repro_torch.analysis` imports no torch; `graph` is imported by
the CLI only with ``--graph``.
"""
from __future__ import annotations

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import lint_paths, lint_source, rule_catalog

__all__ = [
    "Finding",
    "lint_paths",
    "lint_source",
    "rule_catalog",
]
