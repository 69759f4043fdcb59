"""RNG purity: structured seeds and named salts (the port's counterpart of
`repro.analysis.checkers.rng`).

Two rules:

``rng-unstructured-seed``
    Every `np.random.default_rng(...)` takes a structured entropy tuple of
    at least 2 components, `(seed, salt)` or `(seed, salt, round/epoch)`,
    never a bare integer or nothing; legacy global numpy draws
    (`np.random.seed/rand/...`) are flagged unconditionally. The torch
    forms: `<generator>.manual_seed(x)` must take `x` from
    `repro_torch.core.salts` (the module's helpers or a salt in it), or
    from a `np.random.SeedSequence` of a structured tuple (the argument
    itself, or the name's last assignment in its function), so equal
    integer seeds in different subsystems give disjoint streams;
    `torch.manual_seed` (the global stream) is flagged, and so are
    torch's draws that name no `generator=` (`torch.rand*`, `randint`,
    `randperm`, `normal`, `bernoulli`, `multinomial`, and the in-place
    `normal_`, `uniform_`, `bernoulli_`, `random_`, `exponential_`).

``rng-literal-salt``
    Numeric salt literals (inside an entropy tuple, or assigned to a
    `*_SALT` name) belong in the `repro_torch.core.salts` registry, where
    uniqueness is checked at import.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.checkers.base import dotted, is_int_literal
from repro_torch.analysis.findings import Finding

RULES = {
    "rng-unstructured-seed":
        "a generator's seed must derive from core/salts.py or a "
        "structured (seed, salt, round/epoch) tuple; no global streams",
    "rng-literal-salt":
        "numeric salt literals belong in the repro_torch.core.salts "
        "registry",
}

_SALTS_MODULE = "core/salts.py"
_NP_GLOBAL_DRAWS = {
    "seed", "rand", "randn", "randint", "random", "random_sample",
    "permutation", "choice", "shuffle", "uniform", "normal", "integers",
}
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
                "randn_like", "randint_like", "normal", "bernoulli",
                "multinomial", "poisson"}
_INPLACE_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_",
                  "exponential_", "geometric_", "cauchy_", "log_normal_"}


def _is_salts_module(rel: str) -> bool:
    return rel.replace("\\", "/").endswith(_SALTS_MODULE)


def _check_tuple(arg: ast.AST, what: str, rel: str, line: int,
                 out: list[Finding]) -> bool:
    """Whether `arg` is a structured tuple; flags its literal salts."""
    if not isinstance(arg, (ast.Tuple, ast.List)) or len(arg.elts) < 2:
        out.append(Finding(
            file=rel, line=line, rule="rng-unstructured-seed",
            message=f"{what} seed is not a structured entropy tuple — pass "
                    "(seed, salt[, round/epoch]) so streams can't alias "
                    "across subsystems"))
        return False
    for elt in arg.elts:
        if is_int_literal(elt):
            out.append(Finding(
                file=rel, line=elt.lineno, rule="rng-literal-salt",
                message=f"literal salt {elt.value:#x} in an entropy tuple — "
                        "use a named constant from repro_torch.core.salts"))
    return True


def _check_default_rng(node: ast.Call, rel: str, out: list[Finding]) -> None:
    if not node.args and not node.keywords:
        out.append(Finding(
            file=rel, line=node.lineno, rule="rng-unstructured-seed",
            message="default_rng() without a seed is OS entropy — every "
                    "draw must be a pure function of (seed, salt, round)"))
        return
    arg = node.args[0] if node.args else node.keywords[0].value
    _check_tuple(arg, "default_rng", rel, node.lineno, out)


def _structured(expr: ast.AST, rel: str, out: list[Finding],
                assigns=(), line: int = 0, depth: int = 3) -> bool:
    """Whether a seed expression derives from the salts registry or a
    SeedSequence of a structured tuple (its literal salts flagged),
    following names to their last assignment in the scope (`assigns`,
    (line, name, expr) before `line`) `depth` times."""
    for sub in ast.walk(expr):
        name = dotted(sub) if isinstance(sub, (ast.Name, ast.Attribute)) \
            else ""
        if name.startswith("salts.") or name == "salts":
            return True
        if isinstance(sub, ast.Call) and dotted(sub.func).endswith(
                "SeedSequence") and sub.args:
            return _check_tuple(sub.args[0], "SeedSequence", rel,
                                sub.lineno, out)
    if depth:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                found = [e for ln, n, e in assigns
                         if n == sub.id and ln <= line]
                if found and _structured(found[-1], rel, out, assigns, line,
                                         depth - 1):
                    return True
    return False


def _assignments(tree: ast.Module) -> dict[int, list[tuple[int, str, ast.AST]]]:
    """For each function (by id of its node; 0 for the module), its
    `name = expr` assignments as (line, name, expr)."""
    scopes: dict[int, list] = {0: []}

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes[id(child)] = []
                visit(child, id(child))
                continue
            if isinstance(child, ast.Assign):
                for tgt in child.targets:
                    if isinstance(tgt, ast.Name):
                        scopes[scope].append((child.lineno, tgt.id,
                                              child.value))
            visit(child, scope)

    visit(tree, 0)
    return scopes


def _enclosing(tree: ast.Module) -> dict[int, int]:
    """id(call node) -> id of its innermost function (0: module level)."""
    out: dict[int, int] = {}

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            inner = (id(child) if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else scope)
            if isinstance(child, ast.Call):
                out[id(child)] = scope
            visit(child, inner)

    visit(tree, 0)
    return out


def _check_manual_seed(node: ast.Call, rel: str, scopes, enclosing,
                       out: list[Finding]) -> None:
    if not node.args:
        return
    assigns = scopes.get(enclosing.get(id(node), 0), [])
    if not _structured(node.args[0], rel, out, assigns, node.lineno):
        out.append(Finding(
            file=rel, line=node.lineno, rule="rng-unstructured-seed",
            message="manual_seed of a seed that is not derived from "
                    "repro_torch.core.salts or a SeedSequence of a "
                    "structured (seed, salt[, step]) tuple"))


def check(module) -> list[Finding]:
    out: list[Finding] = []
    rel = module.rel
    in_salts = _is_salts_module(rel)
    scopes = enclosing = None
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            base = (name.rsplit(".", 1)[-1] if name else
                    node.func.attr if isinstance(node.func, ast.Attribute)
                    else "")
            kws = {k.arg for k in node.keywords}
            if base == "default_rng" and (name == "default_rng"
                                          or ".random." in f".{name}"):
                _check_default_rng(node, rel, out)
            elif name.startswith(("np.random.", "numpy.random.")) \
                    and base in _NP_GLOBAL_DRAWS:
                out.append(Finding(
                    file=rel, line=node.lineno, rule="rng-unstructured-seed",
                    message=f"global numpy stream np.random.{base} — draws "
                            "are not a pure function of (seed, salt, round)"))
            elif name == "torch.manual_seed":
                out.append(Finding(
                    file=rel, line=node.lineno, rule="rng-unstructured-seed",
                    message="torch.manual_seed seeds torch's global stream — "
                            "draw from a torch.Generator seeded through "
                            "repro_torch.core.salts"))
            elif base == "manual_seed" and not in_salts:
                if scopes is None:
                    scopes = _assignments(module.tree)
                    enclosing = _enclosing(module.tree)
                _check_manual_seed(node, rel, scopes, enclosing, out)
            elif (name.startswith("torch.") and base in _TORCH_DRAWS
                  or isinstance(node.func, ast.Attribute)
                  and node.func.attr in _INPLACE_DRAWS) \
                    and "generator" not in kws:
                out.append(Finding(
                    file=rel, line=node.lineno, rule="rng-unstructured-seed",
                    message=f"{base}() without generator= draws from torch's "
                            "global stream — pass the step's or the "
                            "stream's torch.Generator"))
        elif isinstance(node, ast.Assign) and not in_salts:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and "SALT" in tgt.id.upper() \
                        and is_int_literal(node.value):
                    out.append(Finding(
                        file=rel, line=node.lineno, rule="rng-literal-salt",
                        message=f"salt constant {tgt.id} defined outside the "
                                "repro_torch.core.salts registry — "
                                "uniqueness is unchecked here"))
    return out
