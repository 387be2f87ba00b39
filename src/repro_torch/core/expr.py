"""Expression IR for dense linear algebra expressions.

The PyTorch port's own copy of the reference package's ``core/expr.py``,
cut to what the ``abcd`` and ``aatb`` families need.

The paper (López, Karlsson, Bientinesi, ICPP'22) studies the Linear Algebra
Mapping Problem (LAMP): one expression, many mathematically equivalent
*algorithms* (sequences of kernel calls). This module gives the minimal
symbolic layer needed to describe the paper's expressions — matrix chains
``A·B·C·D`` and Gram products ``A·Aᵀ·B`` — with enough structure (symmetry
tags, transpose) for the enumeration layer to generate every algorithm the
paper considers.

Dims are either concrete ints or symbolic names (str); symbolic dims are what
makes runtime selection (the productized version of the paper) necessary:
when sizes are unknown at trace time the planner must be consulted per
instance.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

Dim = Union[int, str]


def _fmt_dim(d: Dim) -> str:
    return str(d)


@dataclasses.dataclass(frozen=True)
class Matrix:
    """A leaf operand: a dense matrix with (possibly symbolic) dims.

    ``symmetric`` marks operands known symmetric (enables SYMM).
    """

    name: str
    rows: Dim
    cols: Dim
    symmetric: bool = False

    def T(self) -> "Transpose":
        return Transpose(self)

    @property
    def shape(self) -> Tuple[Dim, Dim]:
        return (self.rows, self.cols)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        s = f"{self.name}[{_fmt_dim(self.rows)}x{_fmt_dim(self.cols)}]"
        return s + ("ˢ" if self.symmetric else "")


@dataclasses.dataclass(frozen=True)
class Transpose:
    """Transpose view of a leaf. Only leaves need transposition here."""

    operand: Matrix

    @property
    def rows(self) -> Dim:
        return self.operand.cols

    @property
    def cols(self) -> Dim:
        return self.operand.rows

    @property
    def shape(self) -> Tuple[Dim, Dim]:
        return (self.rows, self.cols)

    @property
    def symmetric(self) -> bool:
        return self.operand.symmetric

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.operand.name}ᵀ"


Operand = Union[Matrix, Transpose]


@dataclasses.dataclass(frozen=True)
class Chain:
    """A product of operands ``ops[0] @ ops[1] @ ... @ ops[-1]``.

    The *expression*; the set of algorithms evaluating it is produced by
    :mod:`repro_torch.core.algorithms`.
    """

    ops: Tuple[Operand, ...]

    def __post_init__(self) -> None:
        if len(self.ops) < 2:
            raise ValueError("Chain needs at least two operands")
        for lhs, rhs in zip(self.ops, self.ops[1:]):
            # Symbolic dims compare by name; mismatch of concrete dims is an
            # immediate error, symbolic-vs-concrete is deferred to bind time.
            a, b = lhs.cols, rhs.rows
            if isinstance(a, int) and isinstance(b, int) and a != b:
                raise ValueError(f"dim mismatch: {lhs} @ {rhs}")

    @property
    def rows(self) -> Dim:
        return self.ops[0].rows

    @property
    def cols(self) -> Dim:
        return self.ops[-1].cols

    def dims(self) -> Tuple[Dim, ...]:
        """The n+1 boundary dims d0..dn of an n-operand chain."""
        ds = [self.ops[0].rows]
        for op in self.ops:
            ds.append(op.cols)
        return tuple(ds)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return " @ ".join(repr(o) for o in self.ops)


def chain(*ops: Operand) -> Chain:
    return Chain(tuple(ops))


def matrix_chain(*dims: Dim, prefix: str = "M") -> Chain:
    """Build the paper's matrix-chain expression from boundary dims d0..dn.

    ``matrix_chain(d0, d1, d2, d3, d4)`` is the paper's ``ABCD`` instance
    ``(d0, d1, d2, d3, d4)``.
    """
    if len(dims) < 3:
        raise ValueError("need at least 3 boundary dims (2 matrices)")
    names = [chr(ord("A") + i) for i in range(len(dims) - 1)]
    mats = [Matrix(n, r, c) for n, r, c in zip(names, dims[:-1], dims[1:])]
    return Chain(tuple(mats))


def gram_times(d0: Dim, d1: Dim, d2: Dim) -> Chain:
    """The paper's second expression ``A·Aᵀ·B`` with A: d0×d1, B: d0×d2."""
    A = Matrix("A", d0, d1)
    B = Matrix("B", d0, d2)
    return Chain((A, A.T(), B))


def bind_dims(c: Chain, env: Dict[str, int]) -> Tuple[int, ...]:
    """Resolve a chain's boundary dims to concrete ints using ``env``."""
    out = []
    for d in c.dims():
        if isinstance(d, str):
            if d not in env:
                raise KeyError(f"unbound symbolic dim {d!r}")
            out.append(int(env[d]))
        else:
            out.append(int(d))
    return tuple(out)
