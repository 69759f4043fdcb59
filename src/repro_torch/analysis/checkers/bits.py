"""Bit-accounting arithmetic outside the compensated helper.

``bits-accounting``
    Direct ``+``/``-`` on a ``bits`` / ``bits_lo`` accumulator anywhere
    but `repro_torch/core/api.py`, where ``accumulate_bits`` keeps the
    ``(bits, bits_lo)`` pair compensated: a plain f32 ``bits + inc``
    stalls once the total passes ~2^24 (the f32 integer gap exceeds the
    round's increment) and the reported communication flatlines.
    Host-side float64 totals carry
    ``# analysis: allow[bits-accounting] <why compensation is unneeded>``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding

RULES = {
    "bits-accounting":
        "arithmetic on a bits/bits_lo accumulator outside "
        "repro_torch.core.api.accumulate_bits (f32 totals stall)",
}

_ACCUMULATOR_NAMES = {"bits", "bits_lo"}
_ALLOWED_MODULE = "repro_torch/core/api.py"


def _is_bits(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return node.id in _ACCUMULATOR_NAMES
    if isinstance(node, ast.Attribute):
        return node.attr in _ACCUMULATOR_NAMES
    if isinstance(node, ast.Subscript):
        return _is_bits(node.value)
    return False


def check(module) -> list[Finding]:
    if module.rel.replace("\\", "/").endswith(_ALLOWED_MODULE):
        return []
    out: list[Finding] = []
    for node in ast.walk(module.tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                      (ast.Add, ast.Sub)):
            if _is_bits(node.left) or _is_bits(node.right):
                out.append(Finding(
                    file=module.rel, line=node.lineno, rule="bits-accounting",
                    message="plain add/sub on a bits accumulator — route it "
                            "through api.accumulate_bits (f32 totals stall "
                            "past ~2^24)"))
        elif isinstance(node, ast.AugAssign) and isinstance(
                node.op, (ast.Add, ast.Sub)):
            if _is_bits(node.target):
                out.append(Finding(
                    file=module.rel, line=node.lineno, rule="bits-accounting",
                    message="augmented add/sub on a bits accumulator — route "
                            "it through api.accumulate_bits (f32 totals "
                            "stall past ~2^24)"))
    return out
