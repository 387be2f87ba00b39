"""CLI: lint the expression zoo / run the mutation-catch gate.

Usage::

    python -m repro_torch.core.analysis                     # whole zoo, smoke+small
    python -m repro_torch.core.analysis --grid full         # heavier grids
    python -m repro_torch.core.analysis --expr atab,abtb    # a subset of families
    python -m repro_torch.core.analysis --mutants           # 8-way mutation gate

Exit status is nonzero on any finding (zoo mode) or any uncaught mutant
(mutation mode), so a script can gate on it.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

from ..cli_help import analysis_rules_epilog
from ..expressions import registered_names
from .findings import format_findings
from .mutants import DEFAULT_SPEC, run_mutation_suite
from .verify import verify_zoo


def _csv(value: str) -> List[str]:
    return [part for part in (p.strip() for p in value.split(",")) if part]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.core.analysis",
        description="Statically verify every algorithm DAG in the "
                    "expression zoo (shapes, storage, liveness, FLOPs).",
        epilog=analysis_rules_epilog(),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "--expr", default=None, metavar="NAME[,NAME...]",
        help="families to lint (default: every registered family: "
             f"{', '.join(registered_names())})")
    parser.add_argument(
        "--grid", default="smoke,small", metavar="GRID[,GRID...]",
        help="named dim grids to lint across (default: smoke,small)")
    parser.add_argument(
        "--mutants", action="store_true",
        help="run the mutation-testing harness instead of the zoo lint: "
             "corrupt a valid family 8 known ways and require the "
             "verifier to catch every class")
    parser.add_argument(
        "--mutant-spec", default=DEFAULT_SPEC, metavar="NAME",
        help=f"family the mutation harness corrupts "
             f"(default: {DEFAULT_SPEC})")
    return parser


def _run_mutants(spec_name: str) -> int:
    outcomes = run_mutation_suite(spec_name)
    caught = sum(1 for o in outcomes if o.caught)
    width = max(len(o.mutant) for o in outcomes)
    for o in outcomes:
        status = "caught" if o.caught else "MISSED"
        print(f"  {o.mutant:<{width}}  expected={o.expected_rule:<18} "
              f"fired={','.join(o.fired_rules) or '-':<30} {status}")
    print(f"mutation suite ({spec_name}): {caught}/{len(outcomes)} caught")
    return 0 if caught == len(outcomes) else 1


def _run_zoo(exprs: Optional[List[str]], grids: List[str]) -> int:
    lint = verify_zoo(grids=grids, exprs=exprs)
    for row in lint.rows:
        status = f"{len(row.findings)} finding(s)" if row.findings else "ok"
        print(f"  {row.family:<10} {row.grid:<8} "
              f"{row.instances:>4} instance(s) {row.algorithms:>5} "
              f"algorithm(s)  {status}")
    findings = lint.findings
    if findings:
        print()
        print(format_findings(findings))
    print(f"zoo lint: {lint.algorithms} algorithm(s) over "
          f"{lint.instances} instance(s), {lint.rules_run} rules, "
          f"{len(findings)} finding(s) in {lint.seconds:.2f}s")
    return 1 if findings else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.mutants:
        return _run_mutants(args.mutant_spec)
    exprs = _csv(args.expr) if args.expr else None
    return _run_zoo(exprs, _csv(args.grid))


if __name__ == "__main__":
    sys.exit(main())
