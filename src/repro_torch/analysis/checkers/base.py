"""Shared AST utilities for the invariant checkers."""
from __future__ import annotations

import ast


def dotted(node: ast.AST) -> str:
    """Dotted name of a Name/Attribute chain ('' otherwise):
    `np.random.default_rng` -> "np.random.default_rng"; anything that is
    not a pure attribute chain (calls, subscripts) gives ''."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


def is_int_literal(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, int) \
        and not isinstance(node.value, bool)


def func_params(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> list[ast.arg]:
    a = fn.args
    return list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)


def is_stub_body(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
    """Docstring-only / `...` / `pass` / `raise NotImplementedError`
    bodies: protocol stubs name arguments they never read."""
    body = fn.body
    if body and isinstance(body[0], ast.Expr) and isinstance(
            body[0].value, ast.Constant) and isinstance(
            body[0].value.value, str):
        body = body[1:]
    if not body:
        return True
    if len(body) > 1:
        return False
    stmt = body[0]
    if isinstance(stmt, ast.Pass):
        return True
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
        return True  # `...`
    if isinstance(stmt, ast.Raise) and stmt.exc is not None:
        name = dotted(stmt.exc.func if isinstance(stmt.exc, ast.Call)
                      else stmt.exc)
        return name.endswith("NotImplementedError")
    return False
