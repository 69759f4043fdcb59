"""The invariant checkers (layer 1 of repro_torch.analysis).

Each module exports ``check(module) -> list[Finding]`` and a ``RULES``
dict documenting its rule ids. Checkers are pure AST passes (no torch
import, no file IO).
"""
from __future__ import annotations

from repro_torch.analysis.checkers import args, bits, kernels, rng, trace

ALL_CHECKERS = (
    rng.check,
    args.check,
    bits.check,
    kernels.check,
    trace.check,
)

RULE_DOCS = [rng.RULES, args.RULES, bits.RULES, kernels.RULES, trace.RULES]
