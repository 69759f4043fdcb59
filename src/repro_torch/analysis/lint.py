"""Layer-1 AST linter: the port's invariant checkers (the port's copy of
`repro.analysis.lint`).

Not a style linter: each checker encodes one invariant the port states in
prose. RNG purity and salt hygiene (every generator seeded from
`core/salts.py` or a structured tuple), ignored semantic arguments,
bit accounting outside `core.api.accumulate_bits`, kernel imports that
bypass `compression/backend.py`, and host syncs inside the steps.

The driver parses every file once into a `Module` (source, AST, allow
annotations) and hands it to each checker; checkers return `Finding`
records. Suppression (inline allows, their required rationale, staleness)
lives here, so no checker sees it.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path

from repro_torch.analysis.findings import Finding

_ALLOW_RE = re.compile(
    r"#\s*analysis:\s*allow\[([a-z0-9_,\- ]+)\]\s*(.*)$")


@dataclasses.dataclass
class Module:
    """One parsed source file, as every checker sees it."""

    rel: str  # repo-relative posix path (what findings report)
    source: str
    tree: ast.Module
    lines: list[str]
    # line -> rule ids allowed on that line (rationale already checked)
    allows: dict[int, set[str]]


def parse_annotations(source: str, rel: str
                      ) -> tuple[dict[int, set[str]], list[Finding]]:
    """Extract `# analysis: allow[rules] rationale` markers per line.

    Only real COMMENT tokens count: an annotation quoted in a docstring is
    not one. A trailing comment covers its own line; an annotation on a
    comment-only line covers the next code line (past any continuation
    comments and blank lines)."""
    allows: dict[int, set[str]] = {}
    findings: list[Finding] = []
    lines = source.splitlines()
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenizeError, IndentationError):
        return allows, findings  # ast.parse reports the syntax error
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _ALLOW_RE.search(tok.string)
        if not m:
            continue
        i = tok.start[0]
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        rationale = m.group(2).strip()
        if not rationale:
            findings.append(Finding(
                file=rel, line=i, rule="allow-missing-rationale",
                message=f"allow[{','.join(sorted(rules))}] has no rationale "
                        "— say why the invariant doesn't apply here"))
            continue
        if lines[i - 1].lstrip().startswith("#"):
            while i < len(lines) and (not lines[i].strip()
                                      or lines[i].lstrip().startswith("#")):
                i += 1
            i += 1
        allows.setdefault(i, set()).update(rules)
    return allows, findings


def parse_module(source: str, rel: str) -> tuple[Module, list[Finding]]:
    lines = source.splitlines()
    allows, findings = parse_annotations(source, rel)
    tree = ast.parse(source, filename=rel)
    return Module(rel=rel, source=source, tree=tree, lines=lines,
                  allows=allows), findings


def _apply_allows(module: Module, findings: list[Finding]) -> list[Finding]:
    """Drop findings covered by an allow on their line; flag stale allows."""
    used: dict[int, set[str]] = {}
    out = []
    for f in findings:
        rules = module.allows.get(f.line, set())
        if f.rule in rules:
            used.setdefault(f.line, set()).add(f.rule)
        else:
            out.append(f)
    for line, rules in module.allows.items():
        stale = rules - used.get(line, set())
        if stale:
            out.append(Finding(
                file=module.rel, line=line, rule="stale-allow",
                message=f"allow[{','.join(sorted(stale))}] suppresses "
                        "nothing on this line — delete it"))
    return out


def lint_source(source: str, rel: str = "<memory>", checkers=None
                ) -> list[Finding]:
    """Lint one in-memory source (the tests' entry point)."""
    from repro_torch.analysis.checkers import ALL_CHECKERS

    module, findings = parse_module(source, rel)
    for check in (ALL_CHECKERS if checkers is None else checkers):
        findings.extend(check(module))
    return sorted(_apply_allows(module, findings))


def iter_source_files(root: Path) -> list[Path]:
    return sorted(p for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts)


def lint_paths(paths: list[Path], *, repo_root: Path) -> list[Finding]:
    """Lint every .py file under `paths`; report repo-relative locations."""
    findings: list[Finding] = []
    for path in paths:
        files = iter_source_files(path) if path.is_dir() else [path]
        for f in files:
            rel = f.resolve().relative_to(repo_root.resolve()).as_posix()
            try:
                findings.extend(lint_source(f.read_text(), rel))
            except SyntaxError as e:  # a file that won't parse IS a finding
                findings.append(Finding(
                    file=rel, line=int(e.lineno or 0), rule="syntax-error",
                    message=str(e.msg)))
    return sorted(findings)


def rule_catalog() -> dict[str, str]:
    """Every lint rule id -> its one-line description."""
    from repro_torch.analysis import checkers
    from repro_torch.analysis.findings import META_RULES

    catalog = dict(META_RULES)
    catalog["syntax-error"] = "file does not parse"
    for mod_rules in checkers.RULE_DOCS:
        catalog.update(mod_rules)
    return catalog
