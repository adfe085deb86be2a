"""CLI: ``python -m repro_torch.analysis`` — run the port's analysis suite
(twin of ``python -m repro.analysis``).

Exit code 1 iff any pass produced an ``error`` finding.  ``--device``
(default ``cuda``) places the suite: on the card the launch-contract lint
launches every accepted point and the lanes run the kernels; ``--device
cpu`` runs everything that needs no card.  The reference's ``--devices``
(a forced host device count) has no counterpart: the sharded scenarios
run on a 1 x 1 mesh here, on gloo or NCCL ranks in the tests and
``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import os
import sys

#: the port's README tables, under headings of their own (the reference's
#: tables sit under "### Rules" / "### Registry coverage")
RULES_HEADER = "#### Port analysis rules"
COVERAGE_HEADER = "#### Port registry coverage"


def _parse_args(argv):
    from repro_torch.analysis.suite import PASSES
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis of the PyTorch port: packed-dataflow "
                    "verification, registry audit, launch-contract lint of "
                    "the CUDA kernels, recompile lint, the static numerics "
                    "bound and the draft-payload proof.")
    ap.add_argument("--passes", default=",".join(PASSES),
                    help=f"comma-separated subset of {','.join(PASSES)}")
    ap.add_argument("--arch", action="append", default=None,
                    help="model-zoo architecture(s) for the scheduler-lane "
                         "passes (default: qwen2_7b)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON on stdout")
    ap.add_argument("--coverage-table", action="store_true",
                    help="print the registry coverage table (markdown)")
    ap.add_argument("--min-severity", default="warning",
                    choices=("error", "warning", "info"),
                    help="lowest severity to print in text mode")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rules glossary and exit")
    ap.add_argument("--sync-docs", action="store_true",
                    help="regenerate the port's rules glossary and registry "
                         "coverage table in README.md, in place")
    ap.add_argument("--check-docs", action="store_true",
                    help="like --sync-docs but read-only: exit 1 if the "
                         "committed README is stale")
    return ap.parse_args(argv)


def _list_rules() -> int:
    from repro_torch.analysis.report import RULES

    width = max(len(r) for r in RULES)
    for rule, text in sorted(RULES.items()):
        print(f"{rule:<{width}}  {text}")
    return 0


def _rules_table() -> str:
    from repro_torch.analysis.report import RULES

    lines = ["| rule | meaning in the port |", "|---|---|"]
    for rule, text in sorted(RULES.items()):
        lines.append(f"| `{rule}` | {' '.join(text.split())} |")
    return "\n".join(lines)


def _replace_table(text: str, header: str, table: str) -> str:
    """Swap the first markdown table after ``header`` for ``table``."""
    i = text.index(header)
    j = text.index("\n|", i) + 1
    end = j
    for line in text[j:].splitlines(keepends=True):
        if not line.startswith("|"):
            break
        end += len(line)
    return text[:j] + table.rstrip("\n") + "\n" + text[end:]


def _readme_path() -> str:
    return os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                         "..", "..", "..", "README.md"))


def _sync_docs(check: bool) -> int:
    """Regenerate the port's README tables; with ``check`` just report
    staleness (exit 1) without writing."""
    from repro_torch.analysis import registry_audit

    readme = _readme_path()
    with open(readme, encoding="utf-8") as fh:
        committed = fh.read()
    _, audit = registry_audit.audit_registry()
    regenerated = _replace_table(committed, RULES_HEADER, _rules_table())
    regenerated = _replace_table(regenerated, COVERAGE_HEADER,
                                 registry_audit.render_coverage(audit))
    if regenerated == committed:
        print("README.md is in sync with repro_torch.analysis")
        return 0
    if check:
        print("README.md is stale: rerun `python -m repro_torch.analysis "
              "--sync-docs` and commit the result", file=sys.stderr)
        return 1
    with open(readme, "w", encoding="utf-8") as fh:
        fh.write(regenerated)
    print(f"rewrote {readme}")
    return 0


def main(argv=None) -> int:
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    if args.list_rules:
        return _list_rules()
    if args.sync_docs or args.check_docs:
        return _sync_docs(check=args.check_docs)

    from repro_torch import resolve_device
    from repro_torch.analysis import registry_audit, suite

    passes = tuple(p.strip() for p in args.passes.split(",") if p.strip())
    unknown = set(passes) - set(suite.PASSES)
    if unknown:
        print(f"unknown pass(es): {', '.join(sorted(unknown))}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    arches = tuple(args.arch) if args.arch else ("qwen2_7b",)

    report, audit_data = suite.run_all(arches=arches, passes=passes, device=device)

    if args.json:
        print(report.dumps())
    else:
        text = report.render(min_severity=args.min_severity)
        if text:
            print(text)
        n_err, n_warn = len(report.errors()), len(report.warnings())
        print(f"repro_torch.analysis: {len(report.findings)} finding(s) "
              f"({n_err} error(s), {n_warn} warning(s)) across "
              f"{', '.join(passes)} on {device}")
    if args.coverage_table and audit_data is not None:
        print()
        print(registry_audit.render_coverage(audit_data))
    return 1 if report.errors() else 0


if __name__ == "__main__":
    raise SystemExit(main())
