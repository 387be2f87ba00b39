"""Independent FLOP recount for every kernel call in a step-DAG.

The paper's whole argument rests on the FLOP number attached to each
algorithm being *right*; this pass re-derives it from first principles —
output-entry count × arithmetic per entry — through a
``functools.singledispatch`` walker over per-kind node types (the tsfc
``flop_count.py`` idiom), and fails on any disagreement with what the
production accounting (:meth:`repro_torch.core.flops.KernelCall.flops` /
:func:`repro_torch.core.flops.total_flops`) claims.

The derivations are deliberately *not* copies of the formulas in
:mod:`repro_torch.core.flops`:

* GEMM: ``m·n`` output entries, each a length-``k`` dot product =
  ``k`` multiplies + ``k`` adds           → ``m·n·(2k)``  (≡ 2mnk)
* SYRK: one triangle of an ``m×m`` product = ``m(m+1)/2`` entries ×
  ``2k``                                  → ``k·m·(m+1)`` (≡ (m+1)mk)
* SYMM: an ``s×o`` product against an ``s×s`` operand = ``s·o``
  entries × ``2s``                        → ``s·o·(2s)``  (≡ 2s²o)
* TRI2FULL: data movement only            → 0

A drift in either formulation — a botched edit to ``flops.py``, or a
:class:`~repro_torch.core.flops.KernelCall` subclass lying through its
``flops`` property — trips ``flop-mismatch`` on every affected
algorithm. New kernel kinds register a node type via
:func:`register_flop_node` plus a ``recount.register`` handler.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

from ..algorithms import Algorithm
from ..flops import KernelCall, total_flops
from .findings import Collector

#: kind -> dims-tuple -> typed node for the singledispatch walker.
NodeBuilder = Callable[[Tuple[int, ...]], object]

FLOP_NODES: Dict[str, NodeBuilder] = {}


def register_flop_node(kind: str, builder: NodeBuilder) -> NodeBuilder:
    """Register the dims->node builder for one kernel kind."""
    if kind in FLOP_NODES:
        raise ValueError(f"flop node for kind {kind!r} already registered")
    FLOP_NODES[kind] = builder
    return builder


@dataclasses.dataclass(frozen=True)
class GemmFlops:
    m: int
    n: int
    k: int


@dataclasses.dataclass(frozen=True)
class SyrkFlops:
    m: int
    k: int


@dataclasses.dataclass(frozen=True)
class SymmFlops:
    s: int
    o: int


@dataclasses.dataclass(frozen=True)
class Tri2FullFlops:
    m: int


@functools.singledispatch
def recount(node: object) -> int:
    """First-principles FLOPs of one typed kernel node."""
    raise NotImplementedError(
        f"no recount handler for {type(node).__name__}; register one via "
        f"recount.register")


@recount.register
def _recount_gemm(node: GemmFlops) -> int:
    # m·n output entries, each a length-k dot: k multiplies + k adds.
    return node.m * node.n * (node.k + node.k)


@recount.register
def _recount_syrk(node: SyrkFlops) -> int:
    # One triangle (incl. diagonal): m(m+1)/2 entries × 2k each.
    return (node.m * (node.m + 1) // 2) * (node.k + node.k)


@recount.register
def _recount_symm(node: SymmFlops) -> int:
    # s·o output entries, each a length-s dot against the symmetric op.
    return node.s * node.o * (node.s + node.s)


@recount.register
def _recount_tri2full(node: Tri2FullFlops) -> int:
    # Pure data movement; the paper charges the copy zero FLOPs (which
    # is itself part of why FLOPs mislead).
    return 0


register_flop_node("gemm", lambda d: GemmFlops(*d))
register_flop_node("syrk", lambda d: SyrkFlops(*d))
register_flop_node("symm", lambda d: SymmFlops(*d))
register_flop_node("tri2full", lambda d: Tri2FullFlops(*d))


def recount_call(call: KernelCall) -> Optional[int]:
    """Independent FLOPs of one call (None: unregistered kind)."""
    builder = FLOP_NODES.get(call.kind)
    if builder is None:
        return None
    try:
        node = builder(call.dims)
    except TypeError:
        return None  # wrong arity: shapes pass already flagged it
    return recount(node)


def registered_flop_kinds() -> List[str]:
    return sorted(FLOP_NODES)


def check_flops(algo: Algorithm, collector: Collector) -> None:
    """Compare claimed per-call and total FLOPs against the recount."""
    recounted_total = 0
    all_counted = True
    for i, step in enumerate(algo.steps):
        call = step.call
        independent = recount_call(call)
        if independent is None:
            all_counted = False
            if call.kind in FLOP_NODES:
                continue  # arity error, already reported by shapes
            collector.emit(
                "unknown-kind",
                f"kernel kind {call.kind!r} has no registered FLOP node; "
                f"register one via repro_torch.core.analysis.register_flop_node",
                step_index=i, step_out=step.out)
            continue
        recounted_total += independent
        claimed = call.flops
        if claimed != independent:
            collector.emit(
                "flop-mismatch",
                f"{call!r} claims {claimed} FLOPs; first-principles "
                f"recount says {independent}",
                step_index=i, step_out=step.out)
    if not all_counted:
        return
    for label, claimed_total in (("total_flops", total_flops(algo.calls)),
                                 ("Algorithm.flops", algo.flops)):
        if claimed_total != recounted_total:
            collector.emit(
                "flop-mismatch",
                f"{label} claims {claimed_total} for the whole algorithm; "
                f"recount sums to {recounted_total}")
