"""Anomaly classification and severity scores (paper §3.3).

An instance is an *anomaly* when the set of FLOP-cheapest algorithms and the
set of fastest algorithms are disjoint — i.e. minimising FLOPs (the
Linnea/Julia/Armadillo strategy) picks a non-fastest algorithm — and the
time score exceeds a threshold (paper uses 10 % for Experiment 1, 5 % for
Experiments 2–3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Classification:
    """Per-instance verdict plus the paper's two severity scores.

    ``time_score`` is (T_cheapest − T_fastest) / T_cheapest ∈ [0, 1): the
    fraction of runtime lost by minimising FLOPs instead of time.

    ``flop_score`` is (F_fastest − F_cheapest) / F_fastest ∈ [0, 1): the
    fraction of FLOPs that buying the *fastest* algorithm costs extra.
    **Convention:** ``F_fastest`` is the FLOP count of the FLOP-cheapest
    member of the fastest set — when several algorithms tie for fastest
    (within ``rel_tol``), the score charges only the cheapest way of being
    fastest, so ties never inflate severity. Both scores are 0 whenever
    their denominator is 0.
    """

    is_anomaly: bool
    time_score: float   # (T_cheapest − T_fastest) / T_cheapest ∈ [0, 1)
    flop_score: float   # (F_fastest − F_cheapest) / F_fastest ∈ [0, 1)
    cheapest: Tuple[str, ...]
    fastest: Tuple[str, ...]


def classify(
    times: Dict[str, float],
    flops: Dict[str, int],
    threshold: float = 0.10,
    rel_tol: float = 1e-9,
) -> Classification:
    """Classify one instance given per-algorithm times and FLOP counts.

    ``times``/``flops`` are keyed by algorithm name. Ties in FLOPs (paper's
    Algs 1/2 and 3/4 for AAᵀB, 2/5 for ABCD) put multiple algorithms in the
    cheapest set; ties in time are resolved with ``rel_tol``.
    """
    if set(times) != set(flops):
        raise ValueError("times and flops must cover the same algorithms")
    f_min = min(flops.values())
    cheapest = tuple(sorted(a for a, f in flops.items() if f == f_min))
    t_min = min(times.values())
    fastest = tuple(sorted(
        a for a, t in times.items() if t <= t_min * (1 + rel_tol)))

    t_cheapest = min(times[a] for a in cheapest)
    time_score = max(0.0, (t_cheapest - t_min) / t_cheapest) \
        if t_cheapest > 0 else 0.0

    # F_fastest: FLOP count of the cheapest among the fastest algorithms.
    f_fastest = min(flops[a] for a in fastest)
    flop_score = max(0.0, (f_fastest - f_min) / f_fastest) \
        if f_fastest > 0 else 0.0

    disjoint = not (set(cheapest) & set(fastest))
    return Classification(
        is_anomaly=bool(disjoint and time_score > threshold),
        time_score=float(time_score),
        flop_score=float(flop_score),
        cheapest=cheapest,
        fastest=fastest,
    )


@dataclasses.dataclass(frozen=True)
class Region:
    """One contiguous anomalous region of the problem-size grid.

    The paper's central empirical claim (§3.4.2) is that anomalies are not
    isolated points but "cluster into large contiguous regions"; a Region
    is one connected component of anomalous grid points (adjacency =
    neighbouring grid coordinates along exactly one axis), with severity
    summaries over its members.
    """

    points: Tuple[Tuple[int, ...], ...]     # sorted member instances
    lo: Tuple[int, ...]                     # bounding box, inclusive
    hi: Tuple[int, ...]
    mean_time_score: float
    max_time_score: float
    mean_flop_score: float
    max_flop_score: float

    @property
    def size(self) -> int:
        return len(self.points)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"Region(size={self.size}, bbox={self.lo}..{self.hi}, "
                f"ts_max={self.max_time_score:.1%})")


def cluster_regions(
    scores: Mapping[Tuple[int, ...], Tuple[float, float]],
    axes: Sequence[Sequence[int]],
) -> List[Region]:
    """Connected components of anomalous grid points (paper's regions).

    ``scores`` maps each *anomalous* point to its ``(time_score,
    flop_score)``; ``axes`` gives the full grid (one sorted value sequence
    per dimension), which defines adjacency: two points are neighbours when
    they agree on all axes but one, and differ by exactly one grid position
    on that axis (so irregular spacings still cluster correctly — adjacency
    is positional, not metric). A point off the grid (wrong dimensionality,
    or a coordinate value not on its axis) raises ``ValueError`` naming the
    point and the offending axis — adaptive refinement and atlas replay make
    this user-reachable, so the error must say which input is bad. Callers
    that legitimately mix off-grid records (e.g. random-search points
    sharing an atlas) filter first, like :func:`repro_torch.core.sweep.cluster_sweep`.

    Returns regions sorted by size (largest first), ties broken by the
    smallest member point, so output is deterministic.
    """
    index = [
        {int(v): i for i, v in enumerate(ax)} for ax in axes
    ]
    coords = {}
    for p in scores:
        if len(p) != len(index):
            raise ValueError(
                f"point {p} has {len(p)} dims but the grid has "
                f"{len(index)} axes")
        c = []
        for d, v in enumerate(p):
            pos = index[d].get(int(v))
            if pos is None:
                raise ValueError(
                    f"point {p} is off-grid: value {v} is not on axis {d} "
                    f"(axis values: {tuple(axes[d])})")
            c.append(pos)
        coords[p] = tuple(c)
    by_coord = {c: p for p, c in coords.items()}

    seen = set()
    regions: List[Region] = []
    for start in sorted(scores):
        if start in seen:
            continue
        members: List[Tuple[int, ...]] = []
        stack = [start]
        seen.add(start)
        while stack:
            p = stack.pop()
            members.append(p)
            c = coords[p]
            for d in range(len(c)):
                for step in (-1, +1):
                    nb = c[:d] + (c[d] + step,) + c[d + 1:]
                    q = by_coord.get(nb)
                    if q is not None and q not in seen:
                        seen.add(q)
                        stack.append(q)
        members.sort()
        ts = [scores[p][0] for p in members]
        fs = [scores[p][1] for p in members]
        regions.append(Region(
            points=tuple(members),
            lo=tuple(min(p[d] for p in members) for d in range(len(start))),
            hi=tuple(max(p[d] for p in members) for d in range(len(start))),
            mean_time_score=sum(ts) / len(ts),
            max_time_score=max(ts),
            mean_flop_score=sum(fs) / len(fs),
            max_flop_score=max(fs),
        ))
    regions.sort(key=lambda r: (-r.size, r.points[0]))
    return regions


def region_summary(regions: Iterable[Region], n_points: int) -> str:
    """Human-readable digest of a clustering pass (CLI / benchmarks)."""
    regions = list(regions)
    n_anom = sum(r.size for r in regions)
    rate = n_anom / n_points if n_points else 0.0
    lines = [f"anomalies: {n_anom}/{n_points} ({rate:.1%}) in "
             f"{len(regions)} region(s)"]
    for i, r in enumerate(regions[:10]):
        lines.append(
            f"  region {i + 1}: size={r.size} bbox={r.lo}..{r.hi} "
            f"ts mean={r.mean_time_score:.1%} max={r.max_time_score:.1%}")
    if len(regions) > 10:
        lines.append(f"  ... {len(regions) - 10} more")
    return "\n".join(lines)
