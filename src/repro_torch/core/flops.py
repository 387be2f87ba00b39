"""FLOP counts for the BLAS kernels used by the paper's algorithms.

These are the paper's §3.1 conventions, verbatim:

* GEMM  (A: m×k, B: k×n)           → 2·m·n·k
* SYRK  (A: m×k, computes A·Aᵀ)    → (m+1)·m·k
* SYMM  (S: m×m symmetric, B: m×n) → 2·m²·n
* TRI2FULL (copy triangle to full m×m) → 0 FLOPs (pure data movement;
  the paper charges it no FLOPs, which is itself part of why FLOPs
  mislead — the copy costs time but not FLOPs).

SYMM dims are always ``(s_dim, other_dim)`` regardless of which side the
symmetric operand multiplies from (``S·B`` vs ``B·S`` cost the same
2·s²·o FLOPs and share calibration-table entries); the side lives on the
enumeration :class:`~repro_torch.core.algorithms.Step` (``symm_side``), which
is what executors consult.

The counts are exposed both as python ints (for the selector) and as a
per-call dataclass so the perf-model layer can attach time estimates.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

#: The kernel vocabulary of the enumeration layer. Profiles, runners and
#: the calibration sweep all branch over exactly these kinds.
KERNEL_KINDS: Tuple[str, ...] = ("gemm", "syrk", "symm", "tri2full")


@dataclasses.dataclass(frozen=True)
class KernelCall:
    """One kernel invocation in an algorithm.

    ``kind``  ∈ {gemm, syrk, symm, tri2full}
    ``dims``  kernel-specific:
        gemm:     (m, n, k)   C[m,n] += A[m,k] B[k,n]
        syrk:     (m, k)      C[m,m] = A[m,k] A[m,k]ᵀ (one triangle)
        symm:     (m, n)      C[m,n] = S[m,m] B[m,n], S symmetric
        tri2full: (m,)        mirror triangle of an m×m matrix
    ``operands`` free-form labels for provenance/debugging.
    """

    kind: str
    dims: Tuple[int, ...]
    operands: Tuple[str, ...] = ()

    @property
    def flops(self) -> int:
        return kernel_flops(self.kind, self.dims)

    @property
    def bytes_moved(self) -> int:
        """Minimum HBM/memory traffic in elements (reads + writes).

        Used by the perf-model discriminant; dtype width is applied there.
        """
        if self.kind == "gemm":
            m, n, k = self.dims
            return m * k + k * n + m * n
        if self.kind == "syrk":
            m, k = self.dims
            return m * k + m * (m + 1) // 2
        if self.kind == "symm":
            m, n = self.dims
            return m * (m + 1) // 2 + 2 * m * n
        if self.kind == "tri2full":
            (m,) = self.dims
            return m * m  # read triangle + write other triangle ≈ m²
        raise ValueError(f"unknown kernel kind {self.kind!r}")

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        d = "x".join(str(x) for x in self.dims)
        ops = ",".join(self.operands)
        return f"{self.kind}({d}{'; ' + ops if ops else ''})"


def kernel_flops(kind: str, dims: Tuple[int, ...]) -> int:
    if kind == "gemm":
        m, n, k = dims
        return 2 * m * n * k
    if kind == "syrk":
        m, k = dims
        return (m + 1) * m * k
    if kind == "symm":
        m, n = dims
        return 2 * m * m * n
    if kind == "tri2full":
        return 0
    raise ValueError(
        f"unknown kernel kind {kind!r}; expected one of {KERNEL_KINDS}")


def gemm(m: int, n: int, k: int, *ops: str) -> KernelCall:
    return KernelCall("gemm", (m, n, k), tuple(ops))


def syrk(m: int, k: int, *ops: str) -> KernelCall:
    return KernelCall("syrk", (m, k), tuple(ops))


def symm(m: int, n: int, *ops: str) -> KernelCall:
    return KernelCall("symm", (m, n), tuple(ops))


def tri2full(m: int, *ops: str) -> KernelCall:
    return KernelCall("tri2full", (m,), tuple(ops))


def total_flops(calls: Iterable[KernelCall]) -> int:
    return sum(c.flops for c in calls)
