"""Ignored-semantic-argument detection (the reference's rule as written).

``ignored-argument``
    A public function (or public method of a public class) that accepts a
    parameter and then either ``del``-etes it or never reads it: the
    signature promises semantics the body ignores (a sampler that takes
    ``epoch``, ``del``-etes it and advances a mutable generator instead
    turns reshuffling into near-with-replacement sampling while every
    call site looks right).

    Only the public surface counts: nested defs, lambdas,
    underscore-prefixed functions and parameters, ``self`` / ``cls``,
    protocol stubs and ``@abstractmethod`` / ``@overload`` declarations
    are exempt. An interface-mandated unused parameter carries
    ``# analysis: allow[ignored-argument] <why the interface needs it>``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.checkers.base import dotted, func_params, is_stub_body
from repro_torch.analysis.findings import Finding

RULES = {
    "ignored-argument":
        "a public function accepts a semantic argument it deletes or "
        "never reads (the `del epoch` sampler bug class)",
}

_EXEMPT_DECORATORS = {"abstractmethod", "overload", "overrides"}


def _is_exempt(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
    if fn.name.startswith("_"):
        return True
    if is_stub_body(fn):
        return True
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if dotted(target).rsplit(".", 1)[-1] in _EXEMPT_DECORATORS:
            return True
    return False


def _public_functions(tree: ast.Module):
    """Module-level functions and methods of public module-level classes."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield item


def _check_function(fn, rel: str, out: list[Finding]) -> None:
    params = {a.arg for a in func_params(fn)} - {"self", "cls"}
    params = {p for p in params if not p.startswith("_")}
    if not params:
        return
    deleted: dict[str, int] = {}
    read: set[str] = set()
    for stmt in fn.body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Delete):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id in params:
                        deleted.setdefault(tgt.id, node.lineno)
            elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                read.add(node.id)
    for p in sorted(params):
        if p in deleted:
            out.append(Finding(
                file=rel, line=deleted[p], rule="ignored-argument",
                message=f"{fn.name}() deletes parameter '{p}' without "
                        "reading it — the signature promises semantics the "
                        "body ignores"))
        elif p not in read:
            out.append(Finding(
                file=rel, line=fn.lineno, rule="ignored-argument",
                message=f"{fn.name}() never reads parameter '{p}' — dead "
                        "semantic surface, or a silently dropped knob"))


def check(module) -> list[Finding]:
    out: list[Finding] = []
    for fn in _public_functions(module.tree):
        if not _is_exempt(fn):
            _check_function(fn, module.rel, out)
    return out
