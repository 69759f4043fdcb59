"""Kernel imports only through the backend.

``kernel-import``
    `repro_torch.kernels.<kernel>` (the wrappers `randk`, `diana_shift`,
    `qsgd`, `pack`, their plain versions' internals, the build) holds the
    CUDA launches; `repro_torch/compression/backend.py` is the dispatch
    layer that picks between a kernel and its plain version and
    re-exports what callers need. Any other module importing a kernel
    couples itself to one backend's internals and bypasses that choice.
    Imported only in `repro_torch/kernels/` and `compression/backend.py`.

    Allowed everywhere, as the reference allows their counterparts (it
    re-exports its geometry constants through the backend): the plain
    arithmetic of `kernels.ref` that is no kernel (`randk_scale`,
    `BLOCK_ROWS`); the launch counts `kernels.LAUNCHES` and
    `kernels.reset_launches` (they launch nothing; the smoke script and
    the experiments read them); and `kernels.census`, the dry run's record
    of launches (it launches nothing).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding

RULES = {
    "kernel-import":
        "a repro_torch.kernels kernel imported outside the kernels package "
        "and compression/backend.py",
}

_ALLOWED_FILES = ("repro_torch/kernels/", "repro_torch/compression/backend.py")
# (module, names it may give anywhere); None: every name
_OPEN = {"repro_torch.kernels": {"LAUNCHES", "reset_launches", "census"},
         "repro_torch.kernels.ref": {"randk_scale", "BLOCK_ROWS"},
         "repro_torch.kernels.census": None}


def _allowed_file(rel: str) -> bool:
    rel = "/" + rel.replace("\\", "/")
    return any(f"/{p}" in rel for p in _ALLOWED_FILES)


def _is_kernels(module: str) -> bool:
    return module.split(".")[:2] == ["repro_torch", "kernels"]


def _open(module: str, names) -> bool:
    if module not in _OPEN:
        return False
    allowed = _OPEN[module]
    return allowed is None or all(n in allowed for n in names)


def check(module) -> list[Finding]:
    if _allowed_file(module.rel):
        return []
    out: list[Finding] = []
    for node in ast.walk(module.tree):
        target = ""
        if isinstance(node, ast.Import):
            hit = [a.name for a in node.names if _is_kernels(a.name)
                   and not _open(a.name, ())]
            target = hit[0] if hit else ""
        elif isinstance(node, ast.ImportFrom) and node.module:
            if _is_kernels(node.module) and not _open(
                    node.module, [a.name for a in node.names]):
                target = node.module
        if target:
            out.append(Finding(
                file=module.rel, line=node.lineno, rule="kernel-import",
                message=f"direct import of {target} — go through "
                        "repro_torch.compression.backend, the dispatch layer "
                        "that picks the kernel or its plain version"))
    return out
