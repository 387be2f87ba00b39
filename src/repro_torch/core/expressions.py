"""The expression zoo: a registry of expression families + their grids.

The PyTorch port's own copy of the reference package's
``core/expressions.py``. The paper studies two expressions (``ABCD``,
``AAᵀB``) and finds that anomaly abundance is *expression-dependent* —
rare for the chain, abundant for the Gram product; the other families
stress-test that conclusion. A family's CLI name, atlas label,
description and grid points are the same in both packages.

Registered families::

    abcd   A·B·C·D            paper §3.2.1 (6 algorithms)
    aatb   A·Aᵀ·B             paper §3.2.2 (5 algorithms)
    abcde  A·B·C·D·E          5-operand chain (4! = 24 orderings)
    abtb   A·Bᵀ·B             right-sided Gram (SYMM side R)
    btsb   Bᵀ·S·B             symmetric sandwich (SYMM either side)
    atab   Aᵀ·A·B             tall-skinny Gram, tri-storage propagation
    abab   (AB)(AB)ᵀ          Gram of a *product* (intermediate SYRK)

Serving families (the decode hot path)::

    decproj  X·W               decode projection GEMM (qkv / logits)
    decattn  P·V·Wo            attention value→output chain (2 orders)
    decmlp   X·Wup·Wdn         MLP up→down chain (2 orders)

Registering a new family::

    def _build_myexpr(dims):          # module-level, like the builders below
        return some_chain_builder(*dims)

    MY_EXPR = register(ExpressionSpec(
        name="MYEXPR", ndims=3, build=_build_myexpr,
        description="what the family is"), cli="myexpr")
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import threading
from typing import Callable, Dict, Iterable, List, Mapping, Sequence, Tuple

from .algorithms import (VERIFY_ENUMERATION_ENV, Algorithm, chain_leaves,
                         enumerate_algorithms)
from .expr import (
    Chain,
    Matrix,
    bind_dims,
    gram_left_times,
    gram_of_product,
    gram_right_times,
    gram_times,
    matrix_chain,
    symmetric_sandwich,
)

# ------------------------------------------------------------------ grids ---

#: Named per-axis dim values; every axis of a grid uses the same values, so
#: an n-dim spec swept at grid g covers len(g)**n instances. Specs with
#: many dims override entries via ``ExpressionSpec.grids`` to keep named
#: sweeps tractable (see ``ABCDE``).
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

    @classmethod
    def named(cls, name: str, ndims: int) -> "GridSpec":
        if name not in SWEEP_GRIDS:
            raise ValueError(
                f"unknown grid {name!r}; expected {sorted(SWEEP_GRIDS)}")
        return cls.uniform(SWEEP_GRIDS[name], ndims, name=name)

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

#: Bound on the enumeration LRU. 1024 point-entries comfortably covers the
#: default grids (6**3 = 216 points) times a handful of families in flight
#: while capping memory for long campaigns.
ALGO_CACHE_MAX = 1024

_ALGO_CACHE: "collections.OrderedDict[Tuple, Tuple[Algorithm, ...]]" = (
    collections.OrderedDict())
_ALGO_CACHE_LOCK = threading.Lock()
_ALGO_CACHE_STATS = {"hits": 0, "misses": 0}


def algorithm_cache_stats() -> Tuple[int, int]:
    """(hits, misses) of the process-wide enumeration LRU."""
    with _ALGO_CACHE_LOCK:
        return (_ALGO_CACHE_STATS["hits"], _ALGO_CACHE_STATS["misses"])


def clear_algorithm_cache() -> None:
    """Drop all memoised enumerations (and reset the hit counters)."""
    with _ALGO_CACHE_LOCK:
        _ALGO_CACHE.clear()
        _ALGO_CACHE_STATS["hits"] = 0
        _ALGO_CACHE_STATS["misses"] = 0


@dataclasses.dataclass(frozen=True)
class ExpressionSpec:
    """A family of instances: tuple of ``ndims`` free dims -> Chain.

    ``build`` is a module-level function (not a lambda/closure), so it
    keys the enumeration cache stably. ``grids`` overrides
    named grids (``SWEEP_GRIDS``) for this family — high-``ndims`` specs
    trim axis values so ``len(values)**ndims`` stays tractable.
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
        """Enumerated algorithms at ``point``, served from a bounded LRU.

        ``measure_instance``, the static verifier and ``chip_smoke.py``'s
        checks enumerate the same points; the cache makes re-enumeration
        free within and across those passes. Keyed by ``(name, build, point)`` — the
        spec itself is frozen-but-unhashable (its ``grids`` mapping), and
        ``build`` is a module-level function, so two registry lookups of
        the same family share entries. Bypassed entirely under
        ``REPRO_VERIFY_ENUMERATION``: callers opting into per-enumeration
        verification must not be served unverified cached results.
        """
        pt = self._check_point(point)
        if os.environ.get(VERIFY_ENUMERATION_ENV):
            return enumerate_algorithms(self.build(pt))
        key = (self.name, self.build, pt)
        with _ALGO_CACHE_LOCK:
            cached = _ALGO_CACHE.get(key)
            if cached is not None:
                _ALGO_CACHE.move_to_end(key)
                _ALGO_CACHE_STATS["hits"] += 1
                return list(cached)
        algos = enumerate_algorithms(self.build(pt))
        with _ALGO_CACHE_LOCK:
            _ALGO_CACHE_STATS["misses"] += 1
            _ALGO_CACHE[key] = tuple(algos)
            _ALGO_CACHE.move_to_end(key)
            while len(_ALGO_CACHE) > ALGO_CACHE_MAX:
                _ALGO_CACHE.popitem(last=False)
        return algos

    def verify(self, point: Sequence[int]):
        """Statically verify this family at ``point``; returns findings.

        Convenience front-end to
        :func:`repro_torch.core.analysis.verify_family` (lazy import: analysis
        layers on top of this module). An empty list means every
        enumerated algorithm passed every analysis rule.
        """
        from .analysis import verify_family

        return verify_family(self, point)

    def grid(self, name: str) -> GridSpec:
        """Named grid for this family: per-spec override ∨ SWEEP_GRIDS."""
        values = self.grids.get(name) or SWEEP_GRIDS.get(name)
        if values is None:
            raise ValueError(
                f"unknown grid {name!r} for expression {self.name}; "
                f"expected one of {sorted(set(SWEEP_GRIDS) | set(self.grids))}")
        return GridSpec.uniform(values, self.ndims, name=name)

    def reference_value(self, point: Sequence[int],
                        operands: Mapping[int, object]):
        """Ground-truth product at ``point`` from base-indexed operands.

        ``operands`` maps leaf *base* index -> matrix (untransposed: numpy
        arrays or tensors), the same contract as every backend's
        ``make_operands`` — the plain left-to-right product every
        algorithm of the family must agree with.
        """
        c = self.chain(point)
        dims = bind_dims(c, {})
        out = None
        for leaf in chain_leaves(c, dims):
            a = operands[leaf.base]
            a = a.T if leaf.transposed else a
            out = a if out is None else out @ a
        return out


# --------------------------------------------------------------- registry ---

#: CLI-name -> spec. :func:`register` is the one way in; the sweep CLI,
#: the static verifier and ``chip_smoke.py`` iterate this mapping.
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


def find_spec(name: str) -> ExpressionSpec:
    """Resolve a CLI key *or* a spec's atlas label (``spec.name``).

    Atlas headers record ``spec.name`` (``"AATB"``), while the CLI speaks
    registry keys (``"aatb"``); replay tooling accepts either spelling.
    """
    key = name.lower()
    if key in REGISTRY:
        return REGISTRY[key]
    for spec in REGISTRY.values():
        if spec.name.lower() == key:
            return spec
    raise KeyError(
        f"no registered expression matches {name!r} (by CLI key or spec "
        f"name); registered: {sorted(REGISTRY)}")


# ----------------------------------------------------- the shipped zoo ------
# Builders are module-level so they key the enumeration cache stably.


def _build_abcd(dims: Sequence[int]) -> Chain:
    return matrix_chain(*dims)


def _build_aatb(dims: Sequence[int]) -> Chain:
    return gram_times(*dims)


def _build_decproj(dims: Sequence[int]) -> Chain:
    t, d, k = dims
    return Chain((Matrix("X", t, d), Matrix("W", d, k)))


def _build_decattn(dims: Sequence[int]) -> Chain:
    t, s, h, d = dims
    P = Matrix("P", t, s)
    V = Matrix("V", s, h)
    Wo = Matrix("Wo", h, d)
    return Chain((P, V, Wo))


def _build_decmlp(dims: Sequence[int]) -> Chain:
    t, d, f = dims
    X = Matrix("X", t, d)
    Wup = Matrix("Wu", d, f)
    Wdn = Matrix("Wd", f, d)
    return Chain((X, Wup, Wdn))


def _build_abcde(dims: Sequence[int]) -> Chain:
    return matrix_chain(*dims)


def _build_abtb(dims: Sequence[int]) -> Chain:
    return gram_right_times(*dims)


def _build_btsb(dims: Sequence[int]) -> Chain:
    return symmetric_sandwich(*dims)


def _build_atab(dims: Sequence[int]) -> Chain:
    return gram_left_times(*dims)


def _build_abab(dims: Sequence[int]) -> Chain:
    return gram_of_product(*dims)


MATRIX_CHAIN_ABCD = register(ExpressionSpec(
    name="ABCD", ndims=5, build=_build_abcd,
    description="paper §3.2.1 4-operand chain (d0..d4); 6 algorithms"),
    cli="abcd")

GRAM_AATB = register(ExpressionSpec(
    name="AATB", ndims=3, build=_build_aatb,
    description="paper §3.2.2 Gram product A·Aᵀ·B (A: d0×d1, B: d0×d2); "
                "5 algorithms"),
    cli="aatb")

MATRIX_CHAIN_ABCDE = register(ExpressionSpec(
    name="ABCDE", ndims=6, build=_build_abcde,
    description="5-operand chain (d0..d5); 4! = 24 orderings",
    # 6 free dims: trim named grids so len(values)**6 stays tractable.
    grids={"small": (32, 64, 96),
           "default": (64, 128, 256, 512),
           "full": (128, 256, 384, 512, 768, 1024)}),
    cli="abcde")

GRAM_ABTB = register(ExpressionSpec(
    name="ABTB", ndims=3, build=_build_abtb,
    description="right-sided Gram A·Bᵀ·B (A: d0×d1, B: d2×d1); SYRK + "
                "SYMM-from-the-right; 5 algorithms"),
    cli="abtb")

SANDWICH_BTSB = register(ExpressionSpec(
    name="BTSB", ndims=2, build=_build_btsb,
    description="symmetric sandwich Bᵀ·S·B (S: d0×d0 symmetric, B: d0×d1); "
                "SYMM on either side; 4 algorithms"),
    cli="btsb")

GRAM_ATAB = register(ExpressionSpec(
    name="ATAB", ndims=3, build=_build_atab,
    description="tall-skinny Gram chain Aᵀ·A·B (A: d0×d1, B: d1×d2); "
                "tri-storage propagation; 5 algorithms"),
    cli="atab")

GRAM_ABAB = register(ExpressionSpec(
    name="ABAB", ndims=3, build=_build_abab,
    description="Gram of a product (AB)(AB)ᵀ (A: d0×d1, B: d1×d2); "
                "intermediate-Gram SYRK; 13 algorithms"),
    cli="abab")

SERVE_DECPROJ = register(ExpressionSpec(
    name="DECPROJ", ndims=3, build=_build_decproj,
    description="serving projection GEMM X·W (X: d0×d1, W: d1×d2); the "
                "skinny decode regime where efficiency dwarfs FLOPs; "
                "1 algorithm"),
    cli="decproj")

SERVE_DECATTN = register(ExpressionSpec(
    name="DECATTN", ndims=4, build=_build_decattn,
    description="decode attention value→output chain P·V·Wo (P: d0×d1, "
                "V: d1×d2, Wo: d2×d3); 2 association orders",
    # 4 free dims: trim named grids so len(values)**4 stays tractable.
    grids={"small": (32, 64, 96),
           "default": (64, 128, 256, 512),
           "full": (128, 256, 512, 1024)}),
    cli="decattn")

SERVE_DECMLP = register(ExpressionSpec(
    name="DECMLP", ndims=3, build=_build_decmlp,
    description="decode MLP chain X·Wup·Wdn (X: d0×d1, Wup: d1×d2, "
                "Wdn: d2×d1); 2 association orders"),
    cli="decmlp")

#: The registry under its pre-registry name, as the reference keeps it.
SPECS = REGISTRY
