"""Shape inference over an algorithm step-DAG.

Walks the steps in execution order, resolving every operand reference
(:class:`~repro_torch.core.algorithms.Leaf` or a previous step's output id) to
a :class:`ValueInfo` and checking, per kernel kind, that the
:class:`~repro_torch.core.flops.KernelCall` dims, the operand shapes, and the
step's declared output shape/tags all agree. Conformance rules live in
an extensible registry (:func:`register_kernel_shape`), so new kernel
kinds (POTRF/TRSM/TRMM/GETRF/GEQRF) plug in without touching this
module.

Emitted rules: ``dangling-ref``, ``stale-out-id``, ``unknown-kind``,
``shape-mismatch``, ``wrong-symm-side``, ``bad-storage-tag``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from ..algorithms import Algorithm, Leaf, Step
from .findings import Collector


@dataclasses.dataclass(frozen=True)
class ValueInfo:
    """Statically known facts about one value in the DAG."""

    rows: int
    cols: int
    storage: str        # 'full' | 'tri'
    symmetric: bool


@dataclasses.dataclass(frozen=True)
class StepView:
    """One step plus its resolved operands, handed to conformance rules.

    ``lhs``/``rhs`` are ``None`` when the reference was dangling (already
    reported) or absent; rules must tolerate that and check what they
    can.
    """

    step: Step
    index: int
    lhs: Optional[ValueInfo]
    rhs: Optional[ValueInfo]
    collector: Collector

    def emit(self, rule_id: str, message: str) -> None:
        self.collector.emit(rule_id, message, step_index=self.index,
                            step_out=self.step.out)


#: Conformance rule: validate dims/operands and return the output
#: :class:`ValueInfo` the kernel *would* produce (or ``None`` when the
#: inputs are too broken to say). The pass separately checks the
#: declared ``out_*`` fields against that return value.
ShapeRule = Callable[[StepView], Optional[ValueInfo]]

KERNEL_SHAPE_RULES: Dict[str, ShapeRule] = {}


def register_kernel_shape(kind: str, rule: ShapeRule) -> ShapeRule:
    """Register the conformance rule for one kernel kind."""
    if kind in KERNEL_SHAPE_RULES:
        raise ValueError(f"shape rule for kind {kind!r} already registered")
    KERNEL_SHAPE_RULES[kind] = rule
    return rule


def _leaf_info(leaf: Leaf) -> ValueInfo:
    return ValueInfo(rows=leaf.rows, cols=leaf.cols, storage=leaf.storage,
                     symmetric=leaf.symmetric)


def resolve(ref: object, env: Dict[int, ValueInfo]) -> Optional[ValueInfo]:
    """Operand reference -> ValueInfo (None: dangling or absent)."""
    if isinstance(ref, Leaf):
        return _leaf_info(ref)
    if isinstance(ref, int):
        return env.get(ref)
    return None


def infer_shapes(algo: Algorithm,
                 collector: Collector) -> Dict[int, ValueInfo]:
    """Run shape inference; returns the step-output environment.

    The environment maps each step's ``out`` id to the *declared* output
    info (so downstream passes agree with what executors would
    materialize), after checking the declaration against the inferred
    shape. Findings go to ``collector``.
    """
    env: Dict[int, ValueInfo] = {}
    for i, step in enumerate(algo.steps):
        for label, ref in (("lhs", step.lhs), ("rhs", step.rhs)):
            if isinstance(ref, int) and ref not in env:
                collector.emit(
                    "dangling-ref",
                    f"{step.call.kind} {label} references step output "
                    f"{ref}, which no earlier step produced",
                    step_index=i, step_out=step.out)
        if step.out in env:
            collector.emit(
                "stale-out-id",
                f"output id {step.out} was already produced by an earlier "
                f"step; downstream reads are ambiguous",
                step_index=i, step_out=step.out)
        view = StepView(step=step, index=i,
                        lhs=resolve(step.lhs, env),
                        rhs=resolve(step.rhs, env),
                        collector=collector)
        rule = KERNEL_SHAPE_RULES.get(step.call.kind)
        if rule is None:
            collector.emit(
                "unknown-kind",
                f"kernel kind {step.call.kind!r} has no registered shape "
                f"rule; register one via "
                f"repro_torch.core.analysis.register_kernel_shape",
                step_index=i, step_out=step.out)
            inferred = None
        else:
            inferred = rule(view)
        declared = ValueInfo(rows=step.out_rows, cols=step.out_cols,
                             storage=step.out_storage,
                             symmetric=step.out_symmetric)
        if inferred is not None:
            if (declared.rows, declared.cols) != (inferred.rows,
                                                  inferred.cols):
                view.emit(
                    "shape-mismatch",
                    f"declared output {declared.rows}x{declared.cols} but "
                    f"{step.call!r} produces "
                    f"{inferred.rows}x{inferred.cols}")
            if declared.storage != inferred.storage:
                view.emit(
                    "bad-storage-tag",
                    f"declared out_storage={declared.storage!r} but "
                    f"{step.call.kind} produces {inferred.storage!r}")
            if inferred.symmetric and not declared.symmetric:
                view.emit(
                    "bad-storage-tag",
                    f"{step.call.kind} output is symmetric by construction "
                    f"but out_symmetric is False")
        if declared.storage == "tri" and not declared.symmetric:
            view.emit(
                "bad-storage-tag",
                "tri storage implies a symmetric value, but out_symmetric "
                "is False (executors would mirror garbage)")
        env[step.out] = declared
    return env


def _dims_ok(view: StepView, arity: int) -> Optional[Tuple[int, ...]]:
    dims = view.step.call.dims
    if len(dims) != arity or any(
            not isinstance(d, int) or d <= 0 for d in dims):
        view.emit(
            "shape-mismatch",
            f"{view.step.call.kind} expects {arity} positive int dim(s), "
            f"got {dims!r}")
        return None
    return dims


def _check_operand(view: StepView, label: str, info: Optional[ValueInfo],
                   rows: int, cols: int) -> None:
    if info is not None and (info.rows, info.cols) != (rows, cols):
        view.emit(
            "shape-mismatch",
            f"{view.step.call.kind} {label} must be {rows}x{cols}, got "
            f"{info.rows}x{info.cols}")


# ----------------------------------------------------- built-in kernels ----


def _gemm_shape(view: StepView) -> Optional[ValueInfo]:
    dims = _dims_ok(view, 3)
    if dims is None:
        return None
    m, n, k = dims
    _check_operand(view, "lhs", view.lhs, m, k)
    _check_operand(view, "rhs", view.rhs, k, n)
    # A gram GEMM (X·Xᵀ) legitimately tags its full output symmetric;
    # symmetry of a general product is not statically decidable here, so
    # the declared flag is trusted either way.
    return ValueInfo(rows=m, cols=n, storage="full",
                     symmetric=view.step.out_symmetric)


def _syrk_shape(view: StepView) -> Optional[ValueInfo]:
    dims = _dims_ok(view, 2)
    if dims is None:
        return None
    m, k = dims
    _check_operand(view, "lhs", view.lhs, m, k)
    # rhs, when recorded, is the transpose twin (provenance only).
    if view.step.rhs is not None:
        _check_operand(view, "rhs (transpose twin)", view.rhs, k, m)
    return ValueInfo(rows=m, cols=m, storage="tri", symmetric=True)


def _symm_shape(view: StepView) -> Optional[ValueInfo]:
    dims = _dims_ok(view, 2)
    if dims is None:
        return None
    s, o = dims
    side = view.step.symm_side
    if side not in ("L", "R"):
        view.emit("wrong-symm-side",
                  f"symm_side must be 'L' or 'R', got {side!r}")
        return None
    sym, gen = (view.lhs, view.rhs) if side == "L" else (view.rhs, view.lhs)
    sym_label = "lhs" if side == "L" else "rhs"
    if sym is not None and not (
            sym.symmetric and sym.rows == sym.cols == s):
        view.emit(
            "wrong-symm-side",
            f"SYMM(side={side}) requires a symmetric {s}x{s} {sym_label}, "
            f"got {sym.rows}x{sym.cols}"
            f"{'' if sym.symmetric else ' (not symmetric)'}")
    gen_label = "rhs" if side == "L" else "lhs"
    gen_rows, gen_cols = (s, o) if side == "L" else (o, s)
    _check_operand(view, gen_label, gen, gen_rows, gen_cols)
    out_rows, out_cols = (s, o) if side == "L" else (o, s)
    return ValueInfo(rows=out_rows, cols=out_cols, storage="full",
                     symmetric=False)


def _tri2full_shape(view: StepView) -> Optional[ValueInfo]:
    dims = _dims_ok(view, 1)
    if dims is None:
        return None
    (m,) = dims
    _check_operand(view, "lhs", view.lhs, m, m)
    if view.lhs is not None and not view.lhs.symmetric:
        view.emit(
            "shape-mismatch",
            "tri2full mirrors a triangle into a symmetric full matrix, "
            "but the operand is not symmetric")
    return ValueInfo(rows=m, cols=m, storage="full", symmetric=True)


register_kernel_shape("gemm", _gemm_shape)
register_kernel_shape("syrk", _syrk_shape)
register_kernel_shape("symm", _symm_shape)
register_kernel_shape("tri2full", _tri2full_shape)


def registered_shape_kinds() -> List[str]:
    return sorted(KERNEL_SHAPE_RULES)
