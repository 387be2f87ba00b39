"""Algorithm enumeration for linear algebra expressions.

An *algorithm* (paper §3.2) is a sequence of kernel calls that evaluates an
expression. Two sources of multiplicity:

1. **Multiplication order** — the chain ``A@B@C@D`` can reduce any adjacent
   pair at each step: (n-1)! orderings for an n-operand chain (the paper's
   3! = 6 for ``ABCD``). Note this is *orderings*, not parenthesizations:
   ``(AB)(CD)`` computed AB-first and CD-first are distinct algorithms
   (paper's Algorithms 2 and 5) because inter-kernel cache effects differ.
2. **Kernel choice** — a Gram pair ``X·Xᵀ`` may use SYRK (triangle output) or
   GEMM; a symmetric operand may use SYMM (from either side) or GEMM; a
   triangle-stored operand used by GEMM needs a TRI2FULL copy first
   (paper's Algorithm 2 for ``AAᵀB``).

Gram pairs are detected by *structural fingerprint*, not leaf adjacency:
an intermediate that is the transpose of another (``(AB)`` next to
``(BᵀAᵀ)``) is a Gram pair too, enumerating the ``GEMM+SYRK`` algorithm
for ``(AB)(AB)ᵀ`` with the never-consumed transpose twin pruned from the
step DAG. Dedup keys are canonical over that DAG (renumbered step ids,
leaves by (base, transposed)), so identical sequences reached via
different search paths collapse.

The enumeration reproduces the paper's sets exactly: 6 algorithms for
``ABCD`` and 5 for ``AAᵀB`` (SYRK+SYMM, SYRK+TRI2FULL+GEMM, GEMM+SYMM,
GEMM+GEMM, GEMM(AᵀB)+GEMM).

For long chains full enumeration explodes as (n-1)!·kernel-choices, so
:func:`enumerate_algorithms` takes a cap.

This is the PyTorch port's own copy of the reference package's
``core/algorithms.py``; the reference's opt-in static verification of
each enumerated family is not carried over.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from .expr import Chain, Transpose, bind_dims
from .flops import KernelCall, gemm, symm, syrk, total_flops, tri2full


@dataclasses.dataclass(frozen=True)
class Leaf:
    """Reference to an input operand.

    ``index`` — position in the chain; ``base`` — position of the first
    chain operand backed by the same underlying Matrix (a Gram pair's
    ``A`` and ``Aᵀ`` share a base, so executors materialize ONE array);
    ``transposed`` — whether this occurrence is the transposed view.
    """

    index: int
    base: int
    transposed: bool
    rows: int
    cols: int
    symmetric: bool = False
    storage: str = "full"


@dataclasses.dataclass(frozen=True)
class Step:
    """One kernel call producing intermediate ``out``.

    ``lhs``/``rhs`` reference either a Leaf or a previous Step's ``out`` id
    (int). ``call`` carries kind+dims+flops. For ``tri2full`` only ``lhs``
    is used; for ``syrk`` only ``lhs`` is *needed* (``rhs`` records the
    transpose twin for provenance and may be None when that operand was
    never materialized). ``symm_side`` disambiguates SYMM: 'L' multiplies
    the symmetric ``lhs`` from the left, 'R' the symmetric ``rhs`` from
    the right — the KernelCall dims are (s_dim, other_dim) either way, so
    calibration tables are side-agnostic while executors are not.
    """

    call: KernelCall
    lhs: object  # Leaf | int
    rhs: object  # Leaf | int | None
    out: int
    out_rows: int
    out_cols: int
    out_storage: str  # 'full' | 'tri'
    out_symmetric: bool
    symm_side: str = "L"


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """A complete kernel-call sequence evaluating the expression."""

    name: str
    steps: Tuple[Step, ...]

    @property
    def calls(self) -> Tuple[KernelCall, ...]:
        return tuple(s.call for s in self.steps)

    @property
    def flops(self) -> int:
        return total_flops(self.calls)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.name}: " + "; ".join(repr(c) for c in self.calls)


@dataclasses.dataclass(frozen=True)
class _Node:
    """Enumeration-time operand: either a leaf or an intermediate.

    ``fp``/``fpT`` are structural fingerprints of the value and of its
    transpose: a leaf is ``("L", base, transposed)`` and a product is
    ``("P", lhs.fp, rhs.fp)`` (with ``(X·Y)ᵀ = Yᵀ·Xᵀ``). Symmetric nodes
    normalize ``fp == fpT``, so ``rhs.fp == lhs.fpT`` detects *any* Gram
    pair ``X·Xᵀ`` — leaf or intermediate — in O(1) per pair.
    """

    ref: object  # Leaf | int (step out id)
    rows: int
    cols: int
    symmetric: bool
    storage: str  # 'full' | 'tri'
    fp: Tuple = ()
    fpT: Tuple = ()


def chain_leaves(c: Chain, dims: Sequence[int]) -> List[Leaf]:
    """The chain's operands as :class:`Leaf` references.

    Operands backed by the same underlying :class:`~repro_torch.core.expr.Matrix`
    share a ``base`` (executors materialize one array per base).
    """
    leaves = []
    seen: Dict[int, int] = {}
    for i, op in enumerate(c.ops):
        mat = op.operand if isinstance(op, Transpose) else op
        base = seen.setdefault(id(mat), i)
        leaves.append(Leaf(index=i, base=base,
                           transposed=isinstance(op, Transpose),
                           rows=dims[i], cols=dims[i + 1],
                           symmetric=op.symmetric))
    return leaves


def _leaf_nodes(c: Chain, dims: Sequence[int]) -> List[_Node]:
    nodes = []
    for leaf in chain_leaves(c, dims):
        if leaf.symmetric:
            # Sᵀ = S: one canonical fingerprint for both views.
            fp = fpT = ("L", leaf.base, False)
        else:
            fp = ("L", leaf.base, leaf.transposed)
            fpT = ("L", leaf.base, not leaf.transposed)
        nodes.append(_Node(ref=leaf, rows=leaf.rows, cols=leaf.cols,
                           symmetric=leaf.symmetric, storage="full",
                           fp=fp, fpT=fpT))
    return nodes


def _is_gram(lhs: _Node, rhs: _Node) -> bool:
    """Is ``lhs @ rhs`` a Gram product ``X·Xᵀ`` (SYRK-able)?

    Fingerprint equality subsumes the adjacent-leaf case (``A·Aᵀ``,
    ``Aᵀ·A``) *and* transpose-equal intermediates (``(AB)·(BᵀAᵀ)``),
    which positional leaf inspection used to miss.
    """
    return rhs.fp == lhs.fpT


def _pair_kernels(
    lhs: _Node, rhs: _Node, gram: bool
) -> Iterator[Tuple[str, Tuple[str, ...], KernelCall, str, bool]]:
    """Yield (label, pres, call, out_storage, out_symmetric) for lhs@rhs.

    ``pres`` lists the sides ('L'/'R') whose triangle-stored operand must
    be mirrored to full (a tri2full step) before ``call`` runs. The rule:
    any operand a kernel reads as a *general* matrix must be full-stored —
    SYRK never touches its rhs, SYMM reads its symmetric side's triangle
    directly, everything else needs the mirror. This is per-operand, so a
    pair of two triangle-stored intermediates (a chain with two Gram
    pairs, e.g. ``A·Aᵀ·B·Bᵀ``) mirrors each side it consumes.
    """
    m, k, n = lhs.rows, lhs.cols, rhs.cols
    pre_l = ("L",) if lhs.storage == "tri" else ()
    pre_r = ("R",) if rhs.storage == "tri" else ()

    if gram:
        # SYRK reads lhs as general data; rhs (its transpose) is unused.
        yield "syrk", pre_l, syrk(m, k), "tri", True
        # GEMM computing the full symmetric product reads both sides.
        yield "gemm", pre_l + pre_r, gemm(m, n, k), "full", True
        return

    # Left operand symmetric → SYMM(side=L): lhs's triangle is read
    # directly (tri or full storage both fine); rhs is general.
    if lhs.symmetric and lhs.rows == lhs.cols:
        yield "symm", pre_r, symm(m, n), "full", False
        # tri2full then plain GEMM (paper's Algorithm 2 for AAᵀB).
        yield "gemm", pre_l + pre_r, gemm(m, n, k), "full", False
        return

    # Right operand symmetric → SYMM(side=R); lhs here is never tri
    # (tri storage implies a symmetric node, handled above).
    if rhs.symmetric and rhs.rows == rhs.cols:
        yield "symmR", (), symm(n, m), "full", False
        yield "gemm", pre_r, gemm(m, n, k), "full", False
        return

    # Plain product (tri implies symmetric, so both sides are full here).
    yield "gemm", (), gemm(m, n, k), "full", False


def _step_label(step: Step) -> str:
    if step.call.kind == "symm" and step.symm_side == "R":
        return "symmR"
    return step.call.kind


def _prune_dead_steps(steps: Tuple[Step, ...],
                      final: object) -> Tuple[Step, ...]:
    """Drop steps whose outputs never reach ``final`` (the result ref).

    A SYRK consumes only its ``lhs`` (the ``rhs`` is the same data,
    transposed), so an intermediate-Gram SYRK makes the step that
    materialized the transpose twin dead — removing it turns the wasteful
    "compute both then SYRK one" sequence into the intended
    "GEMM + SYRK" algorithm, and lets dedup collapse every search path
    that reaches it. Dead references surviving on a SYRK's ``rhs`` are
    rewritten to None.
    """
    live = {final} if isinstance(final, int) else set()
    for step in reversed(steps):
        if step.out not in live:
            continue
        deps = (step.lhs,) if step.call.kind in ("syrk", "tri2full") \
            else (step.lhs, step.rhs)
        live.update(d for d in deps if isinstance(d, int))
    kept = tuple(s for s in steps if s.out in live)
    out_ids = {s.out for s in kept}
    return tuple(
        dataclasses.replace(s, rhs=None)
        if s.call.kind == "syrk" and isinstance(s.rhs, int)
        and s.rhs not in out_ids else s
        for s in kept
    )


def canonical_key(steps: Sequence[Step]) -> Tuple:
    """Canonical identity of a kernel-call sequence over its step DAG.

    Step ``out`` ids come from a global counter, so the same sequence
    reached via different search paths carries different ids — keying on
    raw ``(lhs, rhs)`` refs lets such duplicates survive dedup. The
    canonical key renumbers intermediates by position and identifies
    leaves by ``(base, transposed)`` (occurrence index is cosmetic), so
    two sequences are equal iff they run the same kernels on the same
    data in the same order.
    """
    renum = {s.out: i for i, s in enumerate(steps)}

    def ref(r: object) -> object:
        if isinstance(r, int):
            return ("s", renum[r])
        if r is None:
            return None
        return ("l", r.base, r.transposed)

    return tuple((s.call, s.symm_side, ref(s.lhs), ref(s.rhs))
                 for s in steps)


def enumerate_algorithms(
    c: Chain,
    env: Optional[Dict[str, int]] = None,
    max_algorithms: int = 512,
) -> List[Algorithm]:
    """Enumerate all kernel-call sequences evaluating chain ``c``.

    Reproduces the paper's algorithm sets: 6 for 4-operand chains, 5 for
    ``AAᵀB``. Enumeration is exhaustive in (ordering × kernel choice) up to
    ``max_algorithms``; Gram pairs are detected by structural fingerprint,
    so transpose-equal *intermediates* (``(AB)(AB)ᵀ``) enumerate their
    SYRK variant too, with dead transpose-twin steps pruned.

    """
    dims = bind_dims(c, env or {})
    leaves = _leaf_nodes(c, dims)

    out: List[Algorithm] = []
    seen: Dict[Tuple, None] = {}
    counter = itertools.count()

    def emit(steps: Tuple[Step, ...], final_ref: object) -> None:
        steps = _prune_dead_steps(steps, final_ref)
        key = canonical_key(steps)
        if key in seen:
            return
        seen[key] = None
        name = "+".join(_step_label(s) for s in steps)
        out.append(Algorithm(name=name, steps=steps))

    def rec(nodes: List[_Node], steps: Tuple[Step, ...]) -> None:
        if len(out) >= max_algorithms:
            return
        if len(nodes) == 1:
            final = nodes[0]
            steps_f = steps
            if final.storage == "tri":
                # Result must be materialized as a full matrix.
                sid = next(counter)
                steps_f = steps + (
                    Step(call=tri2full(final.rows), lhs=final.ref, rhs=None,
                         out=sid, out_rows=final.rows, out_cols=final.cols,
                         out_storage="full", out_symmetric=final.symmetric),
                )
                emit(steps_f, sid)
            else:
                emit(steps_f, final.ref)
            return
        for i in range(len(nodes) - 1):
            lhs, rhs = nodes[i], nodes[i + 1]
            gram = _is_gram(lhs, rhs)
            for label, pres, prod, ostore, osym in _pair_kernels(
                    lhs, rhs, gram):
                new_steps = list(steps)
                lref, rref = lhs.ref, rhs.ref
                # tri2full pre-calls mirror each consumed tri operand.
                for side in pres:
                    node = lhs if side == "L" else rhs
                    sid = next(counter)
                    new_steps.append(
                        Step(call=tri2full(node.rows),
                             lhs=lref if side == "L" else rref, rhs=None,
                             out=sid, out_rows=node.rows,
                             out_cols=node.cols, out_storage="full",
                             out_symmetric=True))
                    if side == "L":
                        lref = sid
                    else:
                        rref = sid
                oid = next(counter)
                new_steps.append(
                    Step(call=prod, lhs=lref, rhs=rref, out=oid,
                         out_rows=lhs.rows, out_cols=rhs.cols,
                         out_storage=ostore, out_symmetric=osym,
                         symm_side="R" if label == "symmR" else "L"))
                fp = ("P", lhs.fp, rhs.fp)
                fpT = ("P", rhs.fpT, lhs.fpT)
                if osym:
                    fp = fpT = min(fp, fpT)
                merged = _Node(ref=oid, rows=lhs.rows, cols=rhs.cols,
                               symmetric=osym, storage=ostore,
                               fp=fp, fpT=fpT)
                rec(nodes[:i] + [merged] + nodes[i + 2:], tuple(new_steps))

    rec(leaves, ())
    # Stable, human-auditable naming: ordinal + per-step kernel labels.
    return [
        Algorithm(name=f"alg{i + 1}[{a.name}]", steps=a.steps)
        for i, a in enumerate(out)
    ]
