"""Adaptive boundary-refinement sweeps + multi-host shard fan-out.

The PyTorch port's copy of the reference package's ``core/adaptive.py``,
measuring through the port's :func:`repro_torch.core.sweep.sweep`.

The paper's structural finding — anomalies "cluster into large contiguous
regions" (§3.4.2) — means a dense grid sweep spends most of its budget far
from any region boundary. This module is the active-learning alternative:

* :func:`adaptive_sweep` seeds a coarse sub-lattice of the grid through the
  one measurement path (:func:`repro_torch.core.sweep.sweep`), classifies it,
  clusters the anomalies (:func:`repro_torch.core.anomaly.cluster_regions`), and
  then spends the remaining budget only near region frontiers: *bisection*
  between axis-aligned nearest measured neighbours whose verdicts disagree
  (halving the gap until the boundary sits between adjacent grid cells),
  and *tracing* sideways from each adjacent opposite-verdict pair (walking
  the frontier at full resolution). It iterates until the budget is
  exhausted, a round proposes no new frontier, or the round cap is hit.

* Every measurement streams into the same resumable
  :class:`~repro_torch.core.sweep.AnomalyAtlas`. Budget accounting is
  *trajectory-based*: a point admitted to the trajectory costs one unit of
  budget whether it is measured now or served from the atlas, so a killed
  adaptive sweep re-run with the same arguments deterministically replays
  the rounds already on disk (paying zero new measurements for them),
  resumes mid-round, and converges to exactly the measured set an
  uninterrupted run would have produced.

* ``shard=(k, n)`` fans one trajectory out across ``n`` hosts: every host
  computes the same deterministic candidate sequence, measures only its
  ``k``-th slice into its own per-host shard file
  (``atlas-…-shardK.jsonl``, same header/fingerprint format — see
  :func:`repro_torch.core.sweep.atlas_shard_path`), and reads the sibling shard
  files back at each round boundary for the slices it did not measure.
  Per Peise & Bientinesi (arXiv:1409.8602), measurements are only
  comparable under matching hardware/cache conditions, so sibling shards
  are validated against the same fingerprint/spec/threshold header before
  their classifications are trusted. A host that gets ahead of its
  siblings stops with ``stopped="awaiting-siblings"`` (exit code 3 on the
  CLI) and is simply re-invoked once they catch up — the replay makes the
  re-invocation nearly free. ``tools/atlas_merge.py`` reconciles the shard
  files into one canonical atlas afterwards.

The planted-mask oracles in :mod:`repro_torch.core.synthetic` pin the
contract (``tests/test_torch_adaptive.py``, against the reference): ≥ 0.9 frontier recall at ≤ 40 % of the dense
measurement count, candidates always on-grid and never already measured,
kill/resume convergence, and shard-merge ≡ unsharded equivalence.

Known limitation, by design: refinement only grows from seed hits — an
anomaly region smaller than the seed spacing along every axis can be
missed entirely. Size ``seed_stride`` below the narrowest region that
must not be lost.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set, Tuple

from .anomaly import Region, cluster_regions
from .expressions import GridSpec
from .sweep import AnomalyAtlas, Instance, _spawn_pool, sweep

Point = Tuple[int, ...]


# ------------------------------------------------------- frontier geometry ---


def seed_points(grid: GridSpec, stride: int) -> List[Point]:
    """Coarse sub-lattice: every ``stride``-th index per axis + endpoints.

    Endpoints are always included so the seed brackets the whole grid —
    bisection can only localize boundaries *between* measured points.
    Deterministic row-major order (the budget truncates a prefix of it).
    """
    if stride < 1:
        raise ValueError(f"seed stride must be >= 1, got {stride}")
    axes = []
    for ax in grid.axes:
        idx = list(range(0, len(ax), stride))
        if idx[-1] != len(ax) - 1:
            idx.append(len(ax) - 1)
        axes.append([int(ax[i]) for i in idx])
    return [tuple(p) for p in itertools.product(*axes)]


def _coords(verdicts: Mapping[Point, bool],
            grid: GridSpec) -> Dict[Point, Tuple[int, ...]]:
    """Map measured points to grid-index coordinates (all must be on-grid)."""
    index = [{int(v): i for i, v in enumerate(ax)} for ax in grid.axes]
    out: Dict[Point, Tuple[int, ...]] = {}
    for p in verdicts:
        if len(p) != grid.ndims:
            raise ValueError(
                f"measured point {p} has {len(p)} dims but the grid has "
                f"{grid.ndims} axes")
        c = []
        for d, v in enumerate(p):
            pos = index[d].get(int(v))
            if pos is None:
                raise ValueError(
                    f"measured point {p} is off-grid: value {v} is not on "
                    f"axis {d}")
            c.append(pos)
        out[p] = tuple(c)
    return out


def boundary_cells(verdicts: Mapping[Point, bool],
                   grid: GridSpec) -> Set[Point]:
    """Measured points with a measured grid-adjacent opposite-verdict
    neighbour — the localized frontier (the boundary cells)."""
    coords = _coords(verdicts, grid)
    by_coord = {c: p for p, c in coords.items()}
    out: Set[Point] = set()
    for p, c in coords.items():
        for d in range(grid.ndims):
            for step in (-1, 1):
                q = by_coord.get(c[:d] + (c[d] + step,) + c[d + 1:])
                if q is not None and verdicts[q] != verdicts[p]:
                    out.add(p)
                    break
            else:
                continue
            break
    return out


def refinement_candidates(verdicts: Mapping[Point, bool],
                          grid: GridSpec) -> List[Point]:
    """Unmeasured grid points the next round should measure.

    Two deterministic generators, both driven by axis-aligned *nearest
    measured neighbour* pairs with opposite verdicts:

    * gap ≥ 2 grid positions → the index midpoint (bisection: each round
      halves the bracket until the boundary is between adjacent cells);
    * gap = 1 (a boundary cell pair) → the unmeasured grid neighbours of
      both endpoints along every *other* axis (tracing: the frontier is
      locally perpendicular to the pair's axis, so lateral steps follow
      it at full resolution without re-measuring straight-line interior/
      exterior cells).

    Never proposes an off-grid or already-measured point; sorted output,
    so budget truncation is deterministic.
    """
    coords = _coords(verdicts, grid)
    measured = set(coords.values())
    nd = grid.ndims
    out: Set[Tuple[int, ...]] = set()
    for d in range(nd):
        lines: Dict[Tuple[int, ...], List[Tuple[int, Point]]] = \
            defaultdict(list)
        for p, c in coords.items():
            lines[c[:d] + c[d + 1:]].append((c[d], p))
        for key, col in lines.items():
            col.sort()
            for (ia, pa), (ib, pb) in zip(col, col[1:]):
                if verdicts[pa] == verdicts[pb]:
                    continue
                if ib - ia >= 2:
                    out.add(key[:d] + ((ia + ib) // 2,) + key[d:])
                    continue
                for cend in (coords[pa], coords[pb]):
                    for e in range(nd):
                        if e == d:
                            continue
                        for step in (-1, 1):
                            j = cend[e] + step
                            if 0 <= j < len(grid.axes[e]):
                                out.add(cend[:e] + (j,) + cend[e + 1:])
    return sorted(
        tuple(int(grid.axes[d][i]) for d, i in enumerate(c))
        for c in out if c not in measured
    )


# --------------------------------------------------------- sibling shards ---


def _sibling_records(atlas: AnomalyAtlas,
                     shard: Tuple[int, int]) -> Dict[Point, Instance]:
    """Classifications measured by the other hosts of an n-way fan-out.

    Re-reads every sibling shard file next to ``atlas`` (tolerating torn
    tails exactly like any atlas load); headers are validated against this
    host's fingerprint/spec/threshold, so a foreign shard dropped into the
    directory fails loudly instead of polluting the frontier computation.
    """
    k, n = shard
    own = atlas.path.name
    suffix = f"-shard{k}.jsonl"
    if not own.endswith(suffix):
        raise ValueError(
            f"shard atlas path {atlas.path} does not end in {suffix!r}; "
            f"open it via atlas_shard_path()")
    out: Dict[Point, Instance] = {}
    for j in range(n):
        if j == k:
            continue
        path = atlas.path.with_name(own[:-len(suffix)] + f"-shard{j}.jsonl")
        if not path.is_file():
            continue
        sib = AnomalyAtlas(path, atlas.fingerprint, atlas.spec_name,
                           atlas.threshold, shard=(j, n))
        for rec in sib.records():
            out[rec.point] = rec
    return out


# ------------------------------------------------------------------ engine ---


@dataclasses.dataclass
class RoundStats:
    """One trajectory round (round 0 is the seed)."""

    index: int
    admitted: Tuple[Point, ...]   # global trajectory points, in order
    n_measured: int               # newly measured by this host
    n_cached: int                 # served from this host's atlas
    n_sibling: int                # served from sibling shard files
    n_missing: int                # admitted but not yet known (sibling lag)
    n_regions: int                # anomaly regions known after the round

    @property
    def n_admitted(self) -> int:
        return len(self.admitted)


@dataclasses.dataclass
class AdaptiveResult:
    """Everything an adaptive run learned, plus how it stopped.

    ``stopped`` is one of ``converged`` (a round proposed no new
    frontier), ``budget``, ``rounds`` (round cap), or
    ``awaiting-siblings`` (shard mode only: the trajectory needs
    classifications a sibling host has not written yet — re-invoke after
    the siblings advance; the replay resumes mid-round for free).
    """

    spec_name: str
    grid: GridSpec
    budget: int
    spent: int                    # global trajectory points admitted
    stopped: str
    rounds: List[RoundStats]
    known: Dict[Point, Instance]
    shard: Optional[Tuple[int, int]]
    atlas_path: Optional[Path]
    wall_s: float

    @property
    def n_measured(self) -> int:
        """New measurements performed by this host, this invocation."""
        return sum(r.n_measured for r in self.rounds)

    @property
    def n_refine_rounds(self) -> int:
        return max(0, len(self.rounds) - 1)

    def records(self) -> List[Instance]:
        return list(self.known.values())

    def anomalies(self) -> List[Instance]:
        return [r for r in self.known.values() if r.cls.is_anomaly]

    def verdicts(self) -> Dict[Point, bool]:
        return {p: i.cls.is_anomaly for p, i in self.known.items()}

    def frontier(self) -> Set[Point]:
        """Localized boundary cells among everything known."""
        return boundary_cells(self.verdicts(), self.grid)

    def regions(self) -> List[Region]:
        """Contiguous anomaly regions over the known (sparse) point set."""
        scores = {p: (i.cls.time_score, i.cls.flop_score)
                  for p, i in self.known.items() if i.cls.is_anomaly}
        return cluster_regions(scores, self.grid.axes)


def adaptive_sweep(
    spec,
    grid: GridSpec,
    budget: int,
    rounds: Optional[int] = None,
    *,
    threshold: float = 0.10,
    atlas: Optional[AnomalyAtlas] = None,
    shard: Optional[Tuple[int, int]] = None,
    seed_stride: int = 4,
    runner=None,
    runner_factory: Optional[Callable[[], object]] = None,
    backend: str = "serial",
    shards: Optional[int] = None,
    exec_backend: Optional[str] = None,
    reps: int = 3,
    device: str = "cuda",
    dtype: str = "float32",
    chunk_size: int = 8,
    progress: Optional[Callable[[int, int, Instance], None]] = None,
    fastpath: Optional[bool] = None,
    seed: Optional[int] = None,
) -> AdaptiveResult:
    """Boundary-refining sweep: coarse seed, then budgeted frontier rounds.

    ``budget`` caps the number of *trajectory* points (seed + refinement,
    global across shard hosts); points replayed from the atlas consume
    trajectory budget but zero new measurements, which is what makes a
    resumed run honor the remaining budget instead of the original.
    ``rounds`` caps refinement rounds (``None`` = until budget or
    convergence). Runner/backend knobs — including the fast-path switch
    and operand ``seed`` — are forwarded verbatim to
    :func:`repro_torch.core.sweep.sweep`; with ``backend="process"`` one pool is
    reused across every round, so worker arenas and executable memos
    persist across rounds too (refinement revisits neighbouring shapes).
    ``shard=(k, n)`` requires ``atlas`` to be the host's shard file opened
    with the same shard identity.
    """
    import time as _time

    if budget < 1:
        raise ValueError(f"budget must be >= 1, got {budget}")
    if rounds is not None and rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if grid.ndims != spec.ndims:
        raise ValueError(
            f"grid has {grid.ndims} axes but expression {spec.name} takes "
            f"{spec.ndims} dims")
    if shard is not None:
        k, n = int(shard[0]), int(shard[1])
        if not 0 <= k < n:
            raise ValueError(f"shard must be (k, n) with 0 <= k < n; "
                             f"got {shard}")
        shard = (k, n)
        if atlas is None:
            raise ValueError(
                "shard mode needs the host's shard atlas (open it via "
                "atlas_shard_path) — shards without persistence cannot "
                "be merged")
        if atlas.shard != shard:
            raise ValueError(
                f"atlas {atlas.path} is shard {atlas.shard}, but "
                f"adaptive_sweep was called with shard {shard}")

    t0 = _time.perf_counter()
    known: Dict[Point, Instance] = {}
    stats: List[RoundStats] = []
    executor = None
    if backend == "process":
        # One pool across every round: refinement rounds are many small
        # sweeps, so per-round process start-up would dominate.
        executor = _spawn_pool(shards or os.cpu_count() or 1)

    def run_round(idx: int, admitted: Sequence[Point]) -> bool:
        """Measure this host's slice; pull the rest from siblings.
        Returns True when every admitted point is now known."""
        mine = list(admitted) if shard is None else list(admitted)[k::n]
        res = sweep(spec, mine, runner=runner,
                    runner_factory=runner_factory, backend=backend,
                    shards=shards, exec_backend=exec_backend, reps=reps,
                    device=device, dtype=dtype, chunk_size=chunk_size,
                    threshold=threshold, atlas=atlas, executor=executor,
                    progress=progress, fastpath=fastpath, seed=seed)
        for rec in res.records:
            known[rec.point] = rec
        n_sib = n_missing = 0
        if shard is not None:
            theirs = [p for i, p in enumerate(admitted) if i % n != k]
            if theirs:
                sib = _sibling_records(atlas, shard)
                for p in theirs:
                    inst = sib.get(p)
                    if inst is None:
                        n_missing += 1
                    else:
                        known[p] = inst
                        n_sib += 1
        regions = cluster_regions(
            {p: (i.cls.time_score, i.cls.flop_score)
             for p, i in known.items() if i.cls.is_anomaly},
            grid.axes)
        stats.append(RoundStats(
            index=idx, admitted=tuple(admitted), n_measured=res.n_measured,
            n_cached=res.n_skipped, n_sibling=n_sib, n_missing=n_missing,
            n_regions=len(regions)))
        return n_missing == 0

    try:
        seed = seed_points(grid, seed_stride)
        admitted = seed[:budget]
        spent = len(admitted)
        complete = run_round(0, admitted)
        r = 0
        while True:
            if not complete:
                stopped = "awaiting-siblings"
                break
            if spent >= budget:
                stopped = "budget"
                break
            if rounds is not None and r >= rounds:
                stopped = "rounds"
                break
            cands = refinement_candidates(
                {p: i.cls.is_anomaly for p, i in known.items()}, grid)
            if not cands:
                stopped = "converged"
                break
            r += 1
            admitted = cands[:budget - spent]
            spent += len(admitted)
            complete = run_round(r, admitted)
    finally:
        if executor is not None:
            executor.shutdown()
        if atlas is not None:
            atlas.flush()

    return AdaptiveResult(
        spec_name=spec.name,
        grid=grid,
        budget=budget,
        spent=spent,
        stopped=stopped,
        rounds=stats,
        known=known,
        shard=shard,
        atlas_path=atlas.path if atlas is not None else None,
        wall_s=_time.perf_counter() - t0,
    )
