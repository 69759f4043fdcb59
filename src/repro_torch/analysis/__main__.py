"""CLI: ``python -m repro_torch.analysis --lint --graph``.

Exit status is the gate: 0 iff every finding is fixed or allowed inline
with a reason. ``--lint`` imports no torch; ``--graph`` runs the step
census on the host (fake tensors, `analysis.graph`).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import lint_paths, rule_catalog


def _repo_root() -> Path:
    # src/repro_torch/analysis/__main__.py: the repo root is above src/
    return Path(__file__).resolve().parents[3]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's invariant analysis: AST lint + step census")
    parser.add_argument("--lint", action="store_true",
                        help="run the layer-1 AST checkers over "
                             "src/repro_torch")
    parser.add_argument("--graph", action="store_true",
                        help="run the layer-2 step census (the train step on "
                             "fake tensors; no card)")
    parser.add_argument("--json", action="store_true",
                        help="emit findings as JSON records")
    parser.add_argument("--rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("paths", nargs="*", type=Path,
                        help="files/dirs to lint (default: src/repro_torch)")
    args = parser.parse_args(argv)

    if args.rules:
        catalog = dict(rule_catalog())
        if args.graph:
            from repro_torch.analysis import graph

            catalog.update(graph.RULES)
        for rule, doc in sorted(catalog.items()):
            print(f"{rule:30s} {doc}")
        return 0
    if not (args.lint or args.graph):
        parser.error("nothing to do: pass --lint and/or --graph")

    root = _repo_root()
    findings: list[Finding] = []
    if args.lint:
        paths = args.paths or [root / "src" / "repro_torch"]
        findings.extend(lint_paths(paths, repo_root=root))
    if args.graph:
        from repro_torch.analysis import graph

        findings.extend(graph.run_census())

    if args.json:
        print(json.dumps([f.to_json() for f in findings], indent=2))
    else:
        for f in findings:
            print(f)
    if findings:
        n = len(findings)
        print(f"\n{n} finding{'s' if n != 1 else ''} (fix it, or allow it "
              "inline with its reason)", file=sys.stderr)
        return 1
    mode = "+".join(m for m, on in [("lint", args.lint),
                                    ("graph", args.graph)] if on)
    print(f"analysis clean ({mode})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
