"""Findings and the static-analysis rule registry.

Every check the verifier can perform is declared here as a :class:`Rule`
with a stable kebab-case ``rule_id``, a severity, and a one-line summary.
The registry is the single source of truth consumed by:

* the passes (:mod:`.shapes`, :mod:`.storage`, :mod:`.liveness`,
  :mod:`.flopcheck`) — a pass can only emit findings for registered
  rules, so a typo'd rule id is an immediate ``KeyError``, not a silent
  un-catalogued finding;
* the CLI ``--help`` epilog (:func:`repro_torch.core.cli_help.
  analysis_rules_epilog`), generated from the registry so it can never
  drift;
* the mutation harness (:mod:`.mutants`), whose expected-rule contract
  is expressed in these ids.

A :class:`Finding` is one concrete violation: the rule, where it fired
(algorithm name, step index, step output id), and a human message. The
verifier never raises on findings — callers that want exceptions use
:class:`AnalysisError` via :func:`repro_torch.core.analysis.verify.
assert_algorithms_valid`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

#: Severities, mildest last. ``error`` findings make a DAG invalid
#: (the enumeration hook raises on them);
#: ``warning`` findings are legal-but-wasteful constructs (a redundant
#: TRI2FULL) that the CLI still fails on, because a clean enumeration
#: produces neither.
SEVERITIES: Tuple[str, ...] = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One statically checkable invariant over an algorithm step-DAG."""

    rule_id: str
    severity: str
    summary: str


#: rule_id -> Rule. Populated by :func:`register_rule` at import time
#: (built-ins below) and by new kernel kinds' rule packs at theirs.
RULES: Dict[str, Rule] = {}


def register_rule(rule_id: str, severity: str, summary: str) -> Rule:
    """Declare a rule; returns it (declaration style, like the zoo)."""
    if severity not in SEVERITIES:
        raise ValueError(
            f"unknown severity {severity!r}; expected one of {SEVERITIES}")
    if rule_id in RULES:
        raise ValueError(f"analysis rule {rule_id!r} is already registered")
    rule = Rule(rule_id=rule_id, severity=severity, summary=summary)
    RULES[rule_id] = rule
    return rule


def registered_rules() -> List[str]:
    """Sorted rule ids (the CLI epilog and docs catalog iterate this)."""
    return sorted(RULES)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One concrete rule violation, locatable in its algorithm."""

    rule_id: str
    severity: str
    message: str
    algorithm: Optional[str] = None
    step_index: Optional[int] = None
    step_out: Optional[int] = None

    def __str__(self) -> str:
        where = self.algorithm or "<algorithm>"
        if self.step_index is not None:
            where += f" step#{self.step_index}"
        if self.step_out is not None:
            where += f" (out={self.step_out})"
        return f"[{self.severity}] {self.rule_id} @ {where}: {self.message}"


class Collector:
    """Accumulates findings for one verification run.

    Passes call :meth:`emit` with a registered rule id; the severity is
    looked up from the registry so a pass can never misreport one.
    """

    def __init__(self, algorithm: Optional[str] = None) -> None:
        self.algorithm = algorithm
        self.findings: List[Finding] = []

    def emit(self, rule_id: str, message: str,
             step_index: Optional[int] = None,
             step_out: Optional[int] = None) -> Finding:
        rule = RULES[rule_id]  # KeyError on unregistered rule: a pass bug
        f = Finding(rule_id=rule_id, severity=rule.severity, message=message,
                    algorithm=self.algorithm, step_index=step_index,
                    step_out=step_out)
        self.findings.append(f)
        return f


def errors_only(findings: Sequence[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == "error"]


def format_findings(findings: Sequence[Finding]) -> str:
    return "\n".join(str(f) for f in findings)


class AnalysisError(ValueError):
    """An algorithm DAG failed static verification.

    Raised by the strict entry points (the ``enumerate_algorithms``
    debug hook, :func:`~repro_torch.core.analysis.verify.assert_algorithms_valid`);
    carries the findings for programmatic consumption.
    """

    def __init__(self, message: str, findings: Sequence[Finding]) -> None:
        super().__init__(
            message + "\n" + format_findings(findings) if findings
            else message)
        self.findings: Tuple[Finding, ...] = tuple(findings)


# ----------------------------------------------------- built-in catalog ----
# Dataflow well-formedness.
DANGLING_REF = register_rule(
    "dangling-ref", "error",
    "operand references a step output never defined before use")
STALE_OUT_ID = register_rule(
    "stale-out-id", "error",
    "step redefines an output id an earlier step already produced")
UNKNOWN_KIND = register_rule(
    "unknown-kind", "error",
    "kernel kind has no registered shape/storage/FLOP rules")

# Shape inference.
SHAPE_MISMATCH = register_rule(
    "shape-mismatch", "error",
    "kernel dims are inconsistent with operand or output shapes")
WRONG_SYMM_SIDE = register_rule(
    "wrong-symm-side", "error",
    "SYMM's designated symmetric side is not a symmetric square operand")
BAD_STORAGE_TAG = register_rule(
    "bad-storage-tag", "error",
    "declared storage/symmetry tags are inconsistent with the kernel kind")

# Storage-state dataflow.
RAW_TRI_READ = register_rule(
    "raw-tri-read", "error",
    "general-matrix read of a triangle-stored value without TRI2FULL")
REDUNDANT_TRI2FULL = register_rule(
    "redundant-tri2full", "warning",
    "TRI2FULL applied to an operand that is already full-stored")

# Liveness.
DEAD_STEP = register_rule(
    "dead-step", "error",
    "step output never reaches the algorithm result")
PRUNE_DIVERGENCE = register_rule(
    "prune-divergence", "error",
    "liveness pass disagrees with algorithms._prune_dead_steps")

# FLOP accounting.
FLOP_MISMATCH = register_rule(
    "flop-mismatch", "error",
    "claimed FLOP count disagrees with the independent recount")

# Result contract.
BAD_RESULT = register_rule(
    "bad-result", "error",
    "final result has the wrong shape or is not full-stored")

# Family-level audits.
DUPLICATE_KEY = register_rule(
    "duplicate-key", "error",
    "two enumerated algorithms share a canonical key (dedup unsound)")
