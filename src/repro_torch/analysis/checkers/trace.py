"""Host syncs inside the steps (the port's counterpart of
`repro.analysis.checkers.trace`).

``trace-hazard``
    `.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `float()`/`int()`/
    `bool()` of a torch expression, wall-clock reads and global numpy
    draws inside a function that the train, prefill or serve step runs.
    On the card each either waits for the device (a host sync, which
    stalls the launch queue) or bakes a host value into the step; all of
    them block capturing a step as a CUDA graph.

    Reachability over-approximates: every function of a module whose
    surface runs inside the steps (`STEP_MODULES`: the wire, the rules,
    the backend, the kernels' wrappers, the models, the optimizers) is in
    the step; in `launch/steps.py` the functions reachable from
    `make_train_step`, `make_prefill_step` and `make_serve_step` by
    bare-name calls (nested defs are part of their function). A host read
    the step needs (the MoE grouped FFN's segment sizes, NASTYA's pod
    orders) or host code that lives in such a module carries
    ``# analysis: allow[trace-hazard] <why>``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.checkers.base import dotted
from repro_torch.analysis.findings import Finding

RULES = {
    "trace-hazard":
        "a host sync (.item(), .tolist(), .cpu(), .numpy(), float() of a "
        "tensor), wall clock or global numpy RNG inside a step",
}

# modules whose every function runs inside the steps; matched as a path
# suffix of the repo-relative file
STEP_MODULES = (
    "repro_torch/core/dist.py",
    "repro_torch/core/rules.py",
    "repro_torch/compression/backend.py",
    "repro_torch/models/",
    "repro_torch/optim/optimizers.py",
    "repro_torch/kernels/randk.py",
    "repro_torch/kernels/diana_shift.py",
    "repro_torch/kernels/qsgd.py",
    "repro_torch/kernels/pack.py",
    "repro_torch/kernels/ref.py",
)
# in these modules, only what these functions reach
STEP_ROOTS = {
    "repro_torch/launch/steps.py": ("make_train_step", "make_prefill_step",
                                    "make_serve_step"),
}

_CLOCK_CALLS = {
    "time.time", "time.perf_counter", "time.monotonic", "time.time_ns",
    "time.perf_counter_ns", "time.monotonic_ns", "datetime.now",
    "datetime.datetime.now", "datetime.utcnow",
}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_CASTS = {"float", "int", "bool", "complex"}


def _match(rel: str, suffix: str) -> bool:
    return f"/{suffix}" in "/" + rel.replace("\\", "/")


def _module_functions(tree: ast.Module) -> dict[str, ast.AST]:
    fns: dict[str, ast.AST] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fns[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fns.setdefault(item.name, item)
    return fns


def _reachable(fns: dict[str, ast.AST], roots) -> set[str]:
    """Fixpoint of bare-name calls from the roots to module functions."""
    reached = {r for r in roots if r in fns}
    frontier = list(reached)
    while frontier:
        fn = fns[frontier.pop()]
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                callee = node.func.id
                if callee in fns and callee not in reached:
                    reached.add(callee)
                    frontier.append(callee)
    return reached


def _torch_math(node: ast.AST) -> bool:
    """The expression calls into torch (`torch.`, `F.`): casting its value
    to a Python scalar reads a tensor."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and dotted(sub.func).startswith(
                ("torch.", "F.")):
            return True
    return False


def _hazards(fn: ast.AST, rel: str) -> list[Finding]:
    out: list[Finding] = []
    seen: set[tuple[int, str]] = set()

    def emit(line: int, message: str) -> None:
        if (line, message) not in seen:
            seen.add((line, message))
            out.append(Finding(file=rel, line=line, rule="trace-hazard",
                               message=message))

    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if name in _CLOCK_CALLS:
            emit(node.lineno, f"{name}() inside a step reads the host clock "
                              "(a CUDA graph replays the captured value)")
        elif name.startswith(("np.random.", "numpy.random.")):
            emit(node.lineno, f"{name}() inside a step draws on the host "
                              "from numpy's global stream")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SYNC_METHODS and not node.args:
            emit(node.lineno, f".{node.func.attr}() inside a step waits for "
                              "the device (a host sync; blocks CUDA-graph "
                              "capture)")
        elif isinstance(node.func, ast.Name) and node.func.id in _CASTS \
                and node.args and _torch_math(node.args[0]):
            emit(node.lineno, f"{node.func.id}() of a tensor expression "
                              "inside a step is a host sync")
    return out


def check(module) -> list[Finding]:
    rel = module.rel
    fns = _module_functions(module.tree)
    if any(_match(rel, m) for m in STEP_MODULES):
        traced = set(fns)
    else:
        roots = next((r for m, r in STEP_ROOTS.items() if _match(rel, m)),
                     None)
        if roots is None:
            return []
        traced = _reachable(fns, roots)
    out: list[Finding] = []
    for name in sorted(traced):
        out.extend(_hazards(fns[name], rel))
    return out
