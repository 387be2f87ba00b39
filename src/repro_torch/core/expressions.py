"""The expression registry: families of instances and their sweep grids.

The PyTorch port's own copy of the reference package's
``core/expressions.py``, carrying the paper's two families::

    abcd   A·B·C·D            paper §3.2.1 (6 algorithms)
    aatb   A·Aᵀ·B             paper §3.2.2 (5 algorithms)

The spec and grid types, the named grids and the registry behave as in
the reference, so a family's CLI name, atlas label and grid points are
the same in both packages.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Iterable, List, Mapping, Sequence, Tuple

from .algorithms import Algorithm, enumerate_algorithms
from .expr import Chain, gram_times, matrix_chain

# ------------------------------------------------------------------ grids ---

#: Named per-axis dim values; every axis of a grid uses the same values, so
#: an n-dim spec swept at grid g covers len(g)**n instances.
SWEEP_GRIDS: Dict[str, Tuple[int, ...]] = {
    "smoke": (32, 64),
    "small": (32, 64, 96, 128),
    "default": tuple(range(64, 513, 64)),
    "full": tuple(range(100, 1201, 100)),
}


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """A rectilinear grid of instances: one sorted value axis per dim."""

    name: str
    axes: Tuple[Tuple[int, ...], ...]

    def __post_init__(self):
        for ax in self.axes:
            if list(ax) != sorted(set(int(v) for v in ax)):
                raise ValueError(f"grid axis must be sorted unique ints: {ax}")

    @classmethod
    def uniform(cls, values: Iterable[int], ndims: int,
                name: str = "custom") -> "GridSpec":
        vals = tuple(sorted(set(int(v) for v in values)))
        return cls(name=name, axes=(vals,) * ndims)

    @property
    def ndims(self) -> int:
        return len(self.axes)

    @property
    def n_points(self) -> int:
        out = 1
        for ax in self.axes:
            out *= len(ax)
        return out

    def points(self) -> List[Tuple[int, ...]]:
        """All grid points in deterministic row-major order."""
        return [tuple(p) for p in itertools.product(*self.axes)]


# ------------------------------------------------------- expression specs ---


@dataclasses.dataclass(frozen=True)
class ExpressionSpec:
    """A family of instances: tuple of ``ndims`` free dims -> Chain.

    ``grids`` overrides named grids (``SWEEP_GRIDS``) for this family.
    """

    name: str
    ndims: int
    build: Callable[[Sequence[int]], Chain]
    description: str = ""
    grids: Mapping[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)

    def _check_point(self, point: Sequence[int]) -> Tuple[int, ...]:
        pt = tuple(int(x) for x in point)
        if len(pt) != self.ndims:
            raise ValueError(
                f"expression {self.name} takes {self.ndims} dims, got "
                f"{len(pt)}: {pt} — a mis-shaped grid would silently build "
                f"a different expression")
        return pt

    def chain(self, point: Sequence[int]) -> Chain:
        """The concrete Chain at one instance point (ndims-validated)."""
        return self.build(self._check_point(point))

    def algorithms(self, point: Sequence[int]) -> List[Algorithm]:
        """Every enumerated algorithm of the family at ``point``."""
        return enumerate_algorithms(self.chain(point))

    def grid(self, name: str) -> GridSpec:
        """Named grid for this family: per-spec override ∨ SWEEP_GRIDS."""
        values = self.grids.get(name) or SWEEP_GRIDS.get(name)
        if values is None:
            raise ValueError(
                f"unknown grid {name!r} for expression {self.name}; "
                f"expected one of {sorted(set(SWEEP_GRIDS) | set(self.grids))}")
        return GridSpec.uniform(values, self.ndims, name=name)


# --------------------------------------------------------------- registry ---

#: CLI-name -> spec. :func:`register` is the one way in.
REGISTRY: Dict[str, ExpressionSpec] = {}


def register(spec: ExpressionSpec, cli: str) -> ExpressionSpec:
    """Add ``spec`` under CLI name ``cli``; returns the spec (decl style)."""
    key = cli.lower()
    if key in REGISTRY:
        raise ValueError(f"expression {key!r} is already registered")
    REGISTRY[key] = spec
    return spec


def get_spec(name: str) -> ExpressionSpec:
    """Resolve a CLI name (case-insensitive) to its spec."""
    try:
        return REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown expression {name!r}; registered: "
            f"{sorted(REGISTRY)}") from None


def registered_names() -> List[str]:
    return sorted(REGISTRY)


def _build_abcd(dims: Sequence[int]) -> Chain:
    return matrix_chain(*dims)


def _build_aatb(dims: Sequence[int]) -> Chain:
    return gram_times(*dims)


MATRIX_CHAIN_ABCD = register(ExpressionSpec(
    name="ABCD", ndims=5, build=_build_abcd,
    description="paper §3.2.1 4-operand chain (d0..d4); 6 algorithms"),
    cli="abcd")

GRAM_AATB = register(ExpressionSpec(
    name="AATB", ndims=3, build=_build_aatb,
    description="paper §3.2.2 Gram product A·Aᵀ·B (A: d0×d1, B: d0×d2); "
                "5 algorithms"),
    cli="aatb")
