"""The verifier: run every analysis pass over algorithms and families.

Entry points, from narrowest to widest:

* :func:`verify_algorithm` — one :class:`~repro_torch.core.algorithms.
  Algorithm`: shape inference → storage dataflow → liveness → FLOP
  recount → result contract. Pure; executes nothing.
* :func:`verify_algorithms` — a family's worth of algorithms (one
  expression instance): per-algorithm passes + the family-level
  canonical-key dedup audit + per-algorithm result-shape check against
  the expression's own dims.
* :func:`verify_family` — an :class:`~repro_torch.core.expressions.
  ExpressionSpec` (or CLI name) at one instance point: enumerates, then
  :func:`verify_algorithms`.
* :func:`verify_zoo` — every registered family across named grids: the
  CLI (``python -m repro_torch.core.analysis``) runs this.

:func:`assert_algorithms_valid` is the raising wrapper used by the
``enumerate_algorithms`` debug hook: any *error*-severity
finding raises :class:`~repro_torch.core.analysis.findings.AnalysisError`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..algorithms import Algorithm
from ..expr import Chain, bind_dims
from ..expressions import ExpressionSpec, get_spec, registered_names
from .findings import (
    AnalysisError,
    Collector,
    Finding,
    RULES,
    errors_only,
)
from .flopcheck import check_flops
from .liveness import check_family_dedup, check_liveness
from .shapes import infer_shapes
from .storage import check_storage


def verify_algorithm(
    algo: Algorithm,
    expect_rows: Optional[int] = None,
    expect_cols: Optional[int] = None,
) -> List[Finding]:
    """Statically verify one algorithm; returns all findings (may be []).

    ``expect_rows``/``expect_cols`` pin the result shape to the
    expression the algorithm claims to evaluate (pass both or neither).
    Nothing is executed: every check is over the step-DAG's declared
    structure.
    """
    collector = Collector(algorithm=algo.name)
    env = infer_shapes(algo, collector)
    check_storage(algo, env, collector)
    check_liveness(algo, collector)
    check_flops(algo, collector)
    del env  # passes that need the environment already consumed it
    _check_result(algo, collector, expect_rows, expect_cols)
    return collector.findings


def _check_result(algo: Algorithm, collector: Collector,
                  expect_rows: Optional[int],
                  expect_cols: Optional[int]) -> None:
    if not algo.steps:
        collector.emit("bad-result", "algorithm has no steps")
        return
    final = algo.steps[-1]
    idx = len(algo.steps) - 1
    if final.out_storage != "full":
        collector.emit(
            "bad-result",
            f"result is {final.out_storage!r}-stored; consumers expect a "
            f"full matrix (the enumerator appends a tri2full)",
            step_index=idx, step_out=final.out)
    if expect_rows is not None and expect_cols is not None and (
            (final.out_rows, final.out_cols) != (expect_rows, expect_cols)):
        collector.emit(
            "bad-result",
            f"result is {final.out_rows}x{final.out_cols}; the expression "
            f"evaluates to {expect_rows}x{expect_cols}",
            step_index=idx, step_out=final.out)


def verify_algorithms(
    algos: Sequence[Algorithm],
    chain: Optional[Chain] = None,
    env: Optional[Dict[str, int]] = None,
) -> List[Finding]:
    """Verify a family of algorithms for one expression instance.

    Runs every per-algorithm pass plus the family-level dedup audit.
    With ``chain`` given, each algorithm's result shape is checked
    against the expression's boundary dims (``env`` resolves any
    symbolic dims, as in :func:`repro_torch.core.expr.bind_dims`).
    """
    expect_rows: Optional[int] = None
    expect_cols: Optional[int] = None
    if chain is not None:
        dims = bind_dims(chain, env or {})
        expect_rows, expect_cols = dims[0], dims[-1]
    findings: List[Finding] = []
    for algo in algos:
        findings.extend(verify_algorithm(algo, expect_rows=expect_rows,
                                         expect_cols=expect_cols))
    family_collector = Collector(algorithm=None)
    check_family_dedup(algos, family_collector)
    findings.extend(family_collector.findings)
    return findings


def verify_family(spec: Union[str, ExpressionSpec],
                  point: Sequence[int]) -> List[Finding]:
    """Enumerate one family instance and verify every algorithm of it."""
    if isinstance(spec, str):
        spec = get_spec(spec)
    chain = spec.chain(point)
    return verify_algorithms(spec.algorithms(point), chain=chain)


def assert_algorithms_valid(
    algos: Sequence[Algorithm],
    chain: Optional[Chain] = None,
    env: Optional[Dict[str, int]] = None,
    context: str = "",
) -> None:
    """Raise :class:`AnalysisError` on any error-severity finding."""
    errors = errors_only(verify_algorithms(algos, chain=chain, env=env))
    if errors:
        where = f" for {context}" if context else ""
        raise AnalysisError(
            f"static analysis rejected {len(errors)} error finding(s) in "
            f"{len(algos)} algorithm(s){where}:", errors)


# --------------------------------------------------------- zoo-wide lint ---


@dataclasses.dataclass(frozen=True)
class FamilyLint:
    """Per-(family, grid) lint summary for one zoo run."""

    family: str
    grid: str
    instances: int
    algorithms: int
    findings: Tuple[Finding, ...]


@dataclasses.dataclass(frozen=True)
class ZooLint:
    """Whole-zoo lint result (what the CLI prints and exits on)."""

    rows: Tuple[FamilyLint, ...]
    seconds: float

    @property
    def instances(self) -> int:
        return sum(r.instances for r in self.rows)

    @property
    def algorithms(self) -> int:
        return sum(r.algorithms for r in self.rows)

    @property
    def findings(self) -> List[Finding]:
        return [f for r in self.rows for f in r.findings]

    @property
    def rules_run(self) -> int:
        return len(RULES)


def verify_zoo(
    grids: Sequence[str] = ("smoke",),
    exprs: Optional[Sequence[str]] = None,
) -> ZooLint:
    """Lint every algorithm of every family across the named grids.

    ``exprs`` defaults to every registered family. Grids unknown to a
    family raise (same contract as ``ExpressionSpec.grid``); the
    standard named grids are defined for every family.
    """
    names = list(exprs) if exprs is not None else registered_names()
    rows: List[FamilyLint] = []
    t0 = time.perf_counter()
    for name in names:
        spec = get_spec(name)
        for grid_name in grids:
            grid = spec.grid(grid_name)
            instances = 0
            algorithms = 0
            found: List[Finding] = []
            for point in grid.points():
                algos = spec.algorithms(point)
                found.extend(verify_algorithms(
                    algos, chain=spec.chain(point)))
                instances += 1
                algorithms += len(algos)
            rows.append(FamilyLint(
                family=name, grid=grid_name, instances=instances,
                algorithms=algorithms, findings=tuple(found)))
    return ZooLint(rows=tuple(rows), seconds=time.perf_counter() - t0)
