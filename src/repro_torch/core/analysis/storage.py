"""Storage-state dataflow over an algorithm step-DAG.

Every value in a step-DAG sits at a point of a small storage lattice:

* ``full`` + general — an ordinary dense matrix;
* ``full`` + symmetric — logically symmetric, both triangles present
  (a mirrored SYRK output, a symmetric leaf);
* ``tri`` + symmetric — only one triangle physically written (a raw
  SYRK output); the other triangle is garbage.

``tri`` + general is unrepresentable (the enumeration invariant "tri
implies symmetric"; :mod:`.shapes` flags it as ``bad-storage-tag``).

This pass checks every *read* against what the kernel can legally
consume. The read modes per kernel kind live in an extensible registry
(:func:`register_kernel_reads`):

* ``general`` — the kernel reads the operand as plain dense data; a
  ``tri``-stored operand is the raw-triangle bug class (upper-triangle zeros
  flowing into a GEMM/SYMM) → ``raw-tri-read``.
* ``symmetric`` — the kernel consumes the operand's triangle directly
  (SYMM's symmetric side); ``tri`` or ``full`` storage both legal.
* ``mirror`` — TRI2FULL's input: expected to be ``tri``; a ``full``
  input is legal but wasteful → ``redundant-tri2full`` (warning).

SYRK's recorded ``rhs`` (the transpose twin) is provenance, not a read,
and is not checked here.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from ..algorithms import Algorithm, Step
from .findings import Collector
from .shapes import ValueInfo, resolve

#: (operand label, reference, read mode) triples for one step.
Read = Tuple[str, object, str]

ReadsRule = Callable[[Step], Tuple[Read, ...]]

KERNEL_READS: Dict[str, ReadsRule] = {}

READ_MODES: Tuple[str, ...] = ("general", "symmetric", "mirror")


def register_kernel_reads(kind: str, rule: ReadsRule) -> ReadsRule:
    """Register the read-mode rule for one kernel kind."""
    if kind in KERNEL_READS:
        raise ValueError(f"reads rule for kind {kind!r} already registered")
    KERNEL_READS[kind] = rule
    return rule


def _gemm_reads(step: Step) -> Tuple[Read, ...]:
    return (("lhs", step.lhs, "general"), ("rhs", step.rhs, "general"))


def _syrk_reads(step: Step) -> Tuple[Read, ...]:
    return (("lhs", step.lhs, "general"),)


def _symm_reads(step: Step) -> Tuple[Read, ...]:
    if step.symm_side == "R":
        return (("lhs", step.lhs, "general"), ("rhs", step.rhs, "symmetric"))
    return (("lhs", step.lhs, "symmetric"), ("rhs", step.rhs, "general"))


def _tri2full_reads(step: Step) -> Tuple[Read, ...]:
    return (("lhs", step.lhs, "mirror"),)


register_kernel_reads("gemm", _gemm_reads)
register_kernel_reads("syrk", _syrk_reads)
register_kernel_reads("symm", _symm_reads)
register_kernel_reads("tri2full", _tri2full_reads)


def registered_read_kinds() -> List[str]:
    return sorted(KERNEL_READS)


def check_storage(algo: Algorithm, env: Dict[int, ValueInfo],
                  collector: Collector) -> None:
    """Check every operand read against the storage lattice.

    ``env`` is the step-output environment from
    :func:`repro_torch.core.analysis.shapes.infer_shapes`; dangling references
    resolve to ``None`` and are skipped here (already reported).
    ``unknown-kind`` is likewise :mod:`.shapes`' report — a kind missing
    from this registry but present there is still surfaced, since both
    registries must be extended together.
    """
    for i, step in enumerate(algo.steps):
        rule = KERNEL_READS.get(step.call.kind)
        if rule is None:
            if step.call.kind in _shape_kinds():
                collector.emit(
                    "unknown-kind",
                    f"kernel kind {step.call.kind!r} has a shape rule but "
                    f"no reads rule; register one via "
                    f"repro_torch.core.analysis.register_kernel_reads",
                    step_index=i, step_out=step.out)
            continue
        for label, ref, mode in rule(step):
            info = resolve(ref, env)
            if info is None:
                continue
            if mode == "general" and info.storage == "tri":
                collector.emit(
                    "raw-tri-read",
                    f"{step.call.kind} reads {label} as a general matrix "
                    f"but it is triangle-stored; a tri2full step must "
                    f"mirror it first (the raw-triangle bug class)",
                    step_index=i, step_out=step.out)
            elif mode == "mirror" and info.storage == "full":
                collector.emit(
                    "redundant-tri2full",
                    f"tri2full {label} is already full-stored; the mirror "
                    f"is pure wasted traffic",
                    step_index=i, step_out=step.out)


def _shape_kinds() -> Tuple[str, ...]:
    from .shapes import KERNEL_SHAPE_RULES
    return tuple(KERNEL_SHAPE_RULES)
