"""Planted-mask oracles for the adaptive sweep engine.

The PyTorch port's copy of the reference package's ``core/synthetic.py``
(framework-neutral; the port keeps its own, as it imports nothing of the
reference).

The adaptive engine's headline claim — ≥ 0.9 frontier recall at ≤ 40 % of
the dense measurement budget — is only checkable against ground truth that
is *known by construction*. This module plants it: a mask function decides
which grid points are anomalies, a duck-typed expression spec + runner pair
turns that mask into deterministic measurements the sweep engine consumes
unchanged, and the dense grid evaluated through the mask is the oracle the property
tests (``tests/test_torch_adaptive.py``, against the reference's
``tests/test_adaptive.py``) compare against.

Everything here is a frozen top-level dataclass so specs, masks and runner
factories pickle across the process-pool sweep backend, and two masks with
equal parameters compare equal (the worker-local runner cache keys on the
factory's arguments).

Masks operate on grid *values* (the same tuples the sweep engine
measures), not axis indices; on the uniform grids the harnesses use the
two coincide up to spacing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, Iterable, List, Tuple

from .expressions import GridSpec

Point = Tuple[int, ...]
MaskFn = Callable[[Point], bool]


# ------------------------------------------------------------------ masks ---


@dataclasses.dataclass(frozen=True)
class BlobMask:
    """Euclidean ball: one convex contiguous anomaly region."""

    center: Tuple[int, ...]
    radius: float

    def __call__(self, point: Point) -> bool:
        return sum((float(v) - c) ** 2
                   for v, c in zip(point, self.center)) <= self.radius ** 2


@dataclasses.dataclass(frozen=True)
class StripeMask:
    """Axis-aligned slab spanning the full grid along every other axis."""

    axis: int
    lo: int
    hi: int

    def __call__(self, point: Point) -> bool:
        return self.lo <= point[self.axis] <= self.hi


@dataclasses.dataclass(frozen=True)
class BoxMask:
    """Axis-aligned box, inclusive bounds per dimension."""

    lo: Tuple[int, ...]
    hi: Tuple[int, ...]

    def __call__(self, point: Point) -> bool:
        return all(a <= v <= b for v, a, b in zip(point, self.lo, self.hi))


@dataclasses.dataclass(frozen=True)
class UnionMask:
    """Union of member masks: multi-region and L-shaped plants."""

    masks: Tuple[MaskFn, ...]

    def __call__(self, point: Point) -> bool:
        return any(m(point) for m in self.masks)


@dataclasses.dataclass(frozen=True)
class EmptyMask:
    """No anomalies anywhere — the adaptive sweep must stop at the seed."""

    def __call__(self, point: Point) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class FullMask:
    """Everything anomalous — a region with no frontier to refine."""

    def __call__(self, point: Point) -> bool:
        return True


# ------------------------------------------------- planted spec + runner ---


@dataclasses.dataclass(frozen=True)
class PlantedAlg:
    """Minimal Algorithm stand-in: name + FLOPs + the instance it is for.

    Carrying the point lets :class:`MaskRunner` time by mask lookup —
    real ``Algorithm`` objects only expose dims through their kernel
    calls, which planted masks have no use for.
    """

    name: str
    flops: int
    point: Point
    calls: Tuple = ()
    steps: Tuple = ()


@dataclasses.dataclass(frozen=True)
class PlantedSpec:
    """Duck-typed :class:`~repro_torch.core.expressions.ExpressionSpec`.

    Two algorithms per instance: ``cheap`` (fewest FLOPs) and ``fast``.
    Which one *times* fastest is the mask's call — see
    :class:`MaskRunner`. Satisfies everything ``sweep()`` touches
    (``name``/``ndims``/``algorithms``) and pickles across process pools.
    """

    name: str = "PLANTED"
    ndims: int = 2

    def algorithms(self, point: Iterable[int]) -> List[PlantedAlg]:
        p = tuple(int(x) for x in point)
        if len(p) != self.ndims:
            raise ValueError(
                f"point {p} has {len(p)} dims; {self.name} takes "
                f"{self.ndims}")
        return [PlantedAlg("cheap", 100, p), PlantedAlg("fast", 200, p)]


@dataclasses.dataclass(frozen=True)
class MaskRunner:
    """Deterministic timer that makes ``mask(point)`` the anomaly verdict.

    On masked points the FLOP-cheapest algorithm is slow (disjoint
    cheapest/fastest sets, time score 0.5 ≫ any sane threshold); elsewhere
    the cheapest algorithm is also fastest. Zero noise, so dense and
    adaptive sweeps classify identically and sharded runs replay exactly.
    """

    mask: MaskFn
    slow: float = 2.0
    fast: float = 1.0

    def make_operands(self, alg) -> Dict:
        return {}

    def time_algorithm(self, alg, operands=None) -> float:
        anomalous = bool(self.mask(alg.point))
        if alg.name == "cheap":
            return self.slow if anomalous else self.fast
        return self.fast if anomalous else self.slow


# ----------------------------------------------------------------- oracle ---


def dense_oracle(mask: MaskFn, grid: GridSpec) -> Dict[Point, bool]:
    """Ground truth the dense sweep would measure: every point's verdict."""
    return {p: bool(mask(p)) for p in grid.points()}


def true_frontier(mask: MaskFn, grid: GridSpec) -> FrozenSet[Point]:
    """Both-sided region frontier of the planted mask.

    A grid point is a frontier cell when any grid-positional neighbour
    (adjacent index along exactly one axis) has the opposite verdict —
    the cells :func:`repro_torch.core.adaptive.boundary_cells` converges on
    when the whole frontier has been measured.
    """
    verdicts = dense_oracle(mask, grid)
    axes = [tuple(int(v) for v in ax) for ax in grid.axes]
    index = [{v: i for i, v in enumerate(ax)} for ax in axes]
    out = set()
    for p, v in verdicts.items():
        c = tuple(index[d][x] for d, x in enumerate(p))
        for d in range(len(axes)):
            for step in (-1, 1):
                j = c[d] + step
                if not 0 <= j < len(axes[d]):
                    continue
                q = p[:d] + (axes[d][j],) + p[d + 1:]
                if verdicts[q] != v:
                    out.add(p)
                    break
    return frozenset(out)


def frontier_recall(measured: Iterable[Point],
                    frontier: Iterable[Point]) -> float:
    """Fraction of oracle frontier cells the sweep measured (1.0 if the
    mask has no frontier — nothing to find is fully found)."""
    frontier = set(frontier)
    if not frontier:
        return 1.0
    return len(frontier & set(measured)) / len(frontier)


#: The planted family the property tests and the CI smoke job sweep — name
#: -> (mask builder taking the grid, human description). Builders derive
#: geometry from the grid so one family covers any uniform grid size.
def _mid(ax) -> int:
    return int(ax[len(ax) // 2])


def planted_masks(grid: GridSpec) -> Dict[str, MaskFn]:
    """The six planted ground-truth families, sized to ``grid``.

    Regions are planted wide enough (≥ the default seed stride of 4 index
    steps) that the coarse seed lattice intersects every region — the
    standard active-learning caveat: a region smaller than the seed spacing
    can be missed entirely, by design.
    """
    axes = grid.axes
    spacing = [int(ax[1]) - int(ax[0]) if len(ax) > 1 else 1 for ax in axes]
    lo = [int(ax[0]) for ax in axes]
    hi = [int(ax[-1]) for ax in axes]
    span = [h - x for h, x in zip(hi, lo)]
    center = tuple(_mid(ax) for ax in axes)
    radius = min(span) * 0.28
    third = [x + s // 3 for x, s in zip(lo, span)]
    two_thirds = [x + 2 * s // 3 for x, s in zip(lo, span)]
    quarter_r = min(span) * 0.18
    c_lo = tuple(x + s // 4 for x, s in zip(lo, span))
    c_hi = tuple(x + 3 * s // 4 for x, s in zip(lo, span))
    return {
        "blob": BlobMask(center=center, radius=radius),
        "stripe": StripeMask(axis=0, lo=third[0], hi=two_thirds[0]),
        "lshape": UnionMask((
            BoxMask(lo=tuple(lo), hi=(two_thirds[0],) + tuple(
                x + 2 * s for x, s in zip(lo[1:], spacing[1:]))),
            BoxMask(lo=tuple(lo), hi=(lo[0] + 2 * spacing[0],)
                    + tuple(two_thirds[1:])),
        )),
        "multi": UnionMask((
            BlobMask(center=c_lo, radius=quarter_r),
            BlobMask(center=c_hi, radius=quarter_r),
        )),
        "empty": EmptyMask(),
        "full": FullMask(),
    }
