"""The measured anomaly sweep and its persistent atlas.

The PyTorch port's counterpart of the serial measurement path of the
reference package's ``core/sweep.py``: every algorithm of an expression
is timed at each grid point on an execution backend (by default the
hand-written CUDA kernels), each point is classified (anomalous when the
fastest algorithm is not among the FLOP-cheapest, paper §3.3), and the
results stream into a resumable JSONL atlas keyed by the hardware
fingerprint. The atlas has the reference's header and record schema, so
the reference's replay tools (``repro.core.evaluate.load_atlas_records``,
``tools/atlas_merge.py``) read a port atlas unchanged.

CLI::

    PYTHONPATH=src python -m repro_torch.core.sweep --expr aatb --grid smoke
    PYTHONPATH=src python -m repro_torch.core.sweep --expr aatb --grid smoke  # resumes: measured=0
    PYTHONPATH=src python -m repro_torch.core.sweep --expr abcd --grid 400,1200 --seed 0
    PYTHONPATH=src python -m repro_torch.core.sweep --backend cuda --device cpu --grid smoke
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time as _time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..kernels import ops as kops
from .algorithms import Algorithm, Leaf
from .anomaly import Classification, Region, classify, cluster_regions, region_summary
from .backends import get_backend, register_torch_backends
from .expressions import SWEEP_GRIDS, ExpressionSpec, GridSpec, get_spec, registered_names
from .fingerprint import HardwareFingerprint, cache_base_dir

# --------------------------------------------------- instance measurement ---


def _leaf_bases(alg: Algorithm) -> set:
    """Distinct operand base indices an algorithm's steps reference."""
    return {ref.base for step in alg.steps for ref in (step.lhs, step.rhs)
            if isinstance(ref, Leaf)}


@dataclasses.dataclass
class Instance:
    """One fully measured grid point: per-algorithm times/FLOPs + verdict."""

    point: Tuple[int, ...]
    times: Dict[str, float]
    flops: Dict[str, int]
    cls: Classification


def measure_instance(
    spec: ExpressionSpec,
    point: Sequence[int],
    runner,
    threshold: float = 0.10,
) -> Instance:
    """Time every algorithm for one instance and classify it.

    ``runner`` is any object with ``make_operands(alg) -> dict`` and
    ``time_algorithm(alg, operands) -> seconds`` — every registered
    execution backend qualifies. Operands are synthesized once per point
    and shared by all its algorithms.
    """
    algos = spec.algorithms(point)
    times: Dict[str, float] = {}
    flops: Dict[str, int] = {}
    operands = runner.make_operands(algos[-1])
    for a in algos:
        if not _leaf_bases(a) <= operands.keys():
            for k, v in runner.make_operands(a).items():
                operands.setdefault(k, v)
        times[a.name] = runner.time_algorithm(a, operands)
        flops[a.name] = a.flops
    cls = classify(times, flops, threshold=threshold)
    return Instance(tuple(int(x) for x in point), times, flops, cls)


# ------------------------------------------------------------------ atlas ---

ATLAS_SCHEMA_VERSION = 1

#: Records buffered before a durable flush: a killed sweep loses at most
#: this many measured points.
CHUNK_SIZE = 32

_ENV_ATLAS_DIR = "REPRO_ATLAS_DIR"


class AtlasError(RuntimeError):
    """Atlas file exists but belongs to a different sweep configuration."""


def atlas_dir() -> Path:
    env = os.environ.get(_ENV_ATLAS_DIR)
    if env:
        return Path(env)
    return cache_base_dir() / "atlas"


def _slug(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", s).lower()


def atlas_path(spec_name: str, fingerprint: HardwareFingerprint,
               threshold: float, directory: Optional[Path] = None) -> Path:
    d = Path(directory) if directory is not None else atlas_dir()
    t = f"{threshold:g}".replace(".", "p")
    return d / f"atlas-{_slug(spec_name)}-t{t}-{fingerprint.slug()}.jsonl"


def _instance_to_json(inst: Instance) -> dict:
    return {
        "point": list(inst.point),
        "is_anomaly": inst.cls.is_anomaly,
        "time_score": inst.cls.time_score,
        "flop_score": inst.cls.flop_score,
        "cheapest": list(inst.cls.cheapest),
        "fastest": list(inst.cls.fastest),
        "times": inst.times,
        "flops": inst.flops,
    }


def _instance_from_json(d: dict) -> Instance:
    cls = Classification(
        is_anomaly=bool(d["is_anomaly"]),
        time_score=float(d["time_score"]),
        flop_score=float(d["flop_score"]),
        cheapest=tuple(d["cheapest"]),
        fastest=tuple(d["fastest"]),
    )
    return Instance(
        point=tuple(int(x) for x in d["point"]),
        times={str(k): float(v) for k, v in d["times"].items()},
        flops={str(k): int(v) for k, v in d["flops"].items()},
        cls=cls,
    )


class AnomalyAtlas:
    """Persistent, resumable JSONL store of swept classifications.

    One file per (expression, anomaly threshold, hardware fingerprint).
    Line 1 is a header record ``{"kind": "header", ...}``; every other line
    is one instance. Appends are buffered and flushed in chunks of
    ``CHUNK_SIZE`` (with fsync), so a killed sweep loses at most one
    unflushed chunk and a restart resumes from the last chunk: points
    already on disk are skipped by :func:`sweep`.

    A torn final line (the kill landed mid-write) is tolerated on load;
    any undecodable line is skipped and counted in ``skipped_lines``. A
    shard file of the reference's fanned-out adaptive sweep is refused:
    shards are merged with ``tools/atlas_merge.py`` first.
    """

    def __init__(self, path: Path, fingerprint: HardwareFingerprint,
                 spec_name: str, threshold: float):
        self.path = Path(path)
        self.fingerprint = fingerprint
        self.spec_name = spec_name
        self.threshold = float(threshold)
        self.skipped_lines = 0
        self._records: Dict[Tuple[int, ...], Instance] = {}
        self._buffer: List[str] = []
        self._header_on_disk = False
        self._needs_newline = False
        self.recovered_from: Optional[Path] = None
        if self.path.is_file():
            self._load()

    # -- persistence ------------------------------------------------------
    def _header(self) -> dict:
        return {
            "kind": "header",
            "version": ATLAS_SCHEMA_VERSION,
            "spec": self.spec_name,
            "threshold": self.threshold,
            "fingerprint": self.fingerprint.to_dict(),
        }

    def _load(self) -> None:
        with self.path.open() as f:
            first = f.readline()
            try:
                head = json.loads(first)
            except json.JSONDecodeError:
                # The kill landed mid-write of the header itself: keep the
                # torn file as a sidecar and start the atlas fresh.
                side = self.path.with_suffix(self.path.suffix + ".corrupt")
                self.path.replace(side)
                self.recovered_from = side
                return
            if head.get("kind") != "header":
                raise AtlasError(f"atlas {self.path} is missing its header")
            if head.get("version") != ATLAS_SCHEMA_VERSION:
                raise AtlasError(
                    f"atlas {self.path} has schema version "
                    f"{head.get('version')!r}; this build reads "
                    f"{ATLAS_SCHEMA_VERSION}")
            fp = HardwareFingerprint.from_dict(head["fingerprint"])
            if fp != self.fingerprint:
                raise AtlasError(
                    f"atlas {self.path} was swept on {fp}, but this "
                    f"process targets {self.fingerprint}")
            if head.get("spec") != self.spec_name or \
                    abs(head.get("threshold", -1) - self.threshold) > 1e-12:
                raise AtlasError(
                    f"atlas {self.path} records spec="
                    f"{head.get('spec')!r}/threshold="
                    f"{head.get('threshold')!r}, not "
                    f"{self.spec_name!r}/{self.threshold}")
            if head.get("shard") is not None:
                raise AtlasError(
                    f"atlas {self.path} is shard {head['shard']} of a "
                    f"fanned-out sweep — merge shards with "
                    f"tools/atlas_merge.py instead of resuming one")
            self._header_on_disk = True
            raw = first
            for raw in f:
                line = raw.strip()
                if not line:
                    continue
                try:
                    inst = _instance_from_json(json.loads(line))
                except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                    # Torn tail from a killed writer (or a corrupt line):
                    # drop it; the sweep will re-measure that point.
                    self.skipped_lines += 1
                    continue
                self._records[inst.point] = inst
            # A torn tail has no trailing newline; flush starts with one so
            # the next record is not merged into the garbage line.
            self._needs_newline = not raw.endswith("\n")

    def append(self, inst: Instance) -> bool:
        """Add one instance; returns False (no write) for known points."""
        if inst.point in self._records:
            return False
        self._records[inst.point] = inst
        self._buffer.append(json.dumps(_instance_to_json(inst),
                                       sort_keys=True))
        if len(self._buffer) >= CHUNK_SIZE:
            self.flush()
        return True

    def flush(self) -> None:
        """Durably write buffered records (chunk boundary for resume)."""
        if not self._buffer and self._header_on_disk:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self.path.open("a") as f:
            if self._needs_newline:
                f.write("\n")
                self._needs_newline = False
            if not self._header_on_disk:
                f.write(json.dumps(self._header(), sort_keys=True) + "\n")
                self._header_on_disk = True
            for line in self._buffer:
                f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._buffer.clear()

    # -- queries ----------------------------------------------------------
    def __contains__(self, point: Sequence[int]) -> bool:
        return tuple(int(x) for x in point) in self._records

    def __len__(self) -> int:
        return len(self._records)

    def get(self, point: Sequence[int]) -> Optional[Instance]:
        return self._records.get(tuple(int(x) for x in point))

    def records(self) -> List[Instance]:
        return list(self._records.values())


# ------------------------------------------------------------------ sweep ---


@dataclasses.dataclass
class SweepResult:
    spec_name: str
    records: List[Instance]   # one per requested point (measured or cached)
    n_measured: int
    n_skipped: int            # points served from the atlas
    wall_s: float
    atlas_path: Optional[Path] = None

    @property
    def n_points(self) -> int:
        return len(self.records)

    @property
    def anomalies(self) -> List[Instance]:
        return [r for r in self.records if r.cls.is_anomaly]

    @property
    def anomaly_rate(self) -> float:
        return len(self.anomalies) / len(self.records) if self.records \
            else 0.0

    @property
    def instances_per_s(self) -> float:
        return self.n_measured / self.wall_s if self.wall_s > 0 else 0.0


def sweep(
    spec: ExpressionSpec,
    points: Sequence[Sequence[int]],
    *,
    runner=None,
    threshold: float = 0.10,
    atlas: Optional[AnomalyAtlas] = None,
    reps: int = 3,
    seed: Optional[int] = None,
) -> SweepResult:
    """Measure + classify a set of instances, serially, in this process.

    ``runner`` is the execution backend; without one, a ``cuda`` backend
    (the hand-written kernels, on the card) is built with ``reps`` and
    ``seed`` — with ``seed`` set, every leaf operand is a pure function of
    ``(seed, base, shape)``. Points already in ``atlas`` are *skipped*
    (served from disk), which is what makes a restarted sweep resume;
    newly measured instances stream into the atlas and are flushed in
    chunks. Requested-point order is preserved in the result.
    """
    if atlas is not None and abs(atlas.threshold - threshold) > 1e-12:
        raise ValueError(
            f"atlas {atlas.path} records threshold {atlas.threshold}, but "
            f"sweep() was called with threshold {threshold} — cached and "
            f"new classifications would silently disagree")
    want = list(dict.fromkeys(tuple(int(x) for x in p) for p in points))
    for p in want:
        if len(p) != spec.ndims:
            raise ValueError(
                f"point {p} has {len(p)} dims but expression {spec.name} "
                f"takes {spec.ndims} — check the grid's ndims")
    cached: Dict[Tuple[int, ...], Instance] = {}
    todo: List[Tuple[int, ...]] = []
    for p in want:
        hit = atlas.get(p) if atlas is not None else None
        if hit is not None:
            cached[p] = hit
        else:
            todo.append(p)

    measured: Dict[Tuple[int, ...], Instance] = {}
    t0 = _time.perf_counter()
    try:
        if todo and runner is None:
            register_torch_backends()
            runner = get_backend("cuda", reps=reps, seed=seed)
        for p in todo:
            inst = measure_instance(spec, p, runner, threshold)
            measured[inst.point] = inst
            if atlas is not None:
                atlas.append(inst)
    finally:
        if atlas is not None:
            atlas.flush()

    records = [cached.get(p) or measured[p] for p in want
               if p in cached or p in measured]
    return SweepResult(
        spec_name=spec.name,
        records=records,
        n_measured=len(measured),
        n_skipped=len(cached),
        wall_s=_time.perf_counter() - t0,
        atlas_path=atlas.path if atlas is not None else None,
    )


def cluster_sweep(records, grid: GridSpec) -> List[Region]:
    """Cluster a swept grid's anomalies into contiguous regions.

    Records off the grid are ignored — adjacency is only defined on the
    grid's axes.
    """
    axes_sets = [set(ax) for ax in grid.axes]
    scores: Dict[Tuple[int, ...], Tuple[float, float]] = {}
    for r in records:
        if not r.cls.is_anomaly:
            continue
        if all(v in s for v, s in zip(r.point, axes_sets)):
            scores[r.point] = (r.cls.time_score, r.cls.flop_score)
    return cluster_regions(scores, grid.axes)


# -------------------------------------------------------------------- CLI ---


def parse_grid(spec: ExpressionSpec, text: str) -> GridSpec:
    """A named grid, or comma-separated axis values shared by every dim."""
    if text in SWEEP_GRIDS or text in spec.grids:
        return spec.grid(text)
    try:
        values = [int(v) for v in text.split(",") if v.strip()]
    except ValueError:
        raise ValueError(
            f"--grid must name one of {sorted(SWEEP_GRIDS)} or be "
            f"comma-separated ints; got {text!r}") from None
    return GridSpec.uniform(values, spec.ndims)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.sweep",
        description="Measured anomaly sweep over a problem-size grid on "
                    "the PyTorch port; results persist in the resumable "
                    "anomaly atlas.")
    ap.add_argument("--expr", choices=registered_names(), default="aatb")
    ap.add_argument("--grid", default="small",
                    help=f"named grid {sorted(SWEEP_GRIDS)} or "
                         "comma-separated axis values, e.g. 400,800,1200")
    ap.add_argument("--backend", choices=("cuda", "torch"), default="cuda",
                    help="cuda: the hand-written kernels; torch: plain ATen")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu, "
                         "where the kernels' plain versions run")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=None,
                    help="operand-synthesis seed: every leaf becomes a "
                         "pure function of (seed, base, shape)")
    ap.add_argument("--threshold", type=float, default=0.10)
    ap.add_argument("--atlas-dir", type=Path, default=None,
                    help="atlas directory (default: $REPRO_ATLAS_DIR or "
                         "~/.cache/repro/atlas)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    spec = get_spec(args.expr)
    try:
        grid = parse_grid(spec, args.grid)
    except ValueError as e:
        ap.error(str(e))
    register_torch_backends()
    runner = get_backend(args.backend, device=args.device, reps=args.reps,
                         seed=args.seed)
    fp = runner.fingerprint()
    atlas = AnomalyAtlas(atlas_path(spec.name, fp, args.threshold,
                                    args.atlas_dir),
                         fp, spec.name, args.threshold)
    if not args.quiet:
        print(f"sweep {spec.name} grid={grid.name} ({grid.n_points} "
              f"instances over {spec.ndims} dims), backend={args.backend} "
              f"on {fp.device}; atlas {atlas.path} ({len(atlas)} already "
              f"recorded)", file=sys.stderr)

    kops.reset_launch_counts()
    res = sweep(spec, grid.points(), runner=runner,
                threshold=args.threshold, atlas=atlas)
    print(f"sweep {spec.name}/{grid.name} [{args.backend}]: "
          f"points={res.n_points} measured={res.n_measured} "
          f"skipped={res.n_skipped} anomalies={len(res.anomalies)} "
          f"({res.anomaly_rate:.1%}) in {res.wall_s:.1f}s "
          f"[{res.instances_per_s:.1f} inst/s]")
    print("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in kops.launch_counts().items()))
    print(region_summary(cluster_sweep(res.records, grid), res.n_points))
    print(f"atlas written to {res.atlas_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
