"""Finding records (the port's copy of `repro.analysis.findings`).

A finding is a structured record (rule id, repo-relative file, 1-based
line, message), never free text, so a gate can hold the exact set.

Suppression is inline only, explicit and self-checking:
``# analysis: allow[rule-a,rule-b] rationale`` on the offending line (or
the ``def`` line for function-level rules). The rationale is REQUIRED: an
allow without one is itself a finding (``allow-missing-rationale``), and
an allow that suppresses nothing is a finding too (``stale-allow``), so
annotations cannot rot in place. The reference's baseline file has no
counterpart: every finding of the port is fixed or allowed inline.
"""
from __future__ import annotations

import dataclasses

META_RULES = {
    "allow-missing-rationale":
        "an `# analysis: allow[...]` annotation must state why",
    "stale-allow":
        "an allow annotation that no longer suppresses any finding",
}


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One invariant violation: where, which rule, and what it means."""

    file: str  # repo-relative posix path, or a trace label (step:...)
    line: int  # 1-based; 0 for whole-file / graph-level findings
    rule: str  # kebab-case id from the rule catalog
    message: str

    def __str__(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        return f"{loc}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

