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

``--mode predict`` classifies from per-kernel times measured in isolation
(:func:`benchmark_unique_calls`, reusing and extending the cached profile)
through the additive model; ``--mode evaluate`` replays the atlas and
scores the registered discriminants (:mod:`repro_torch.core.evaluate`).

CLI::

    PYTHONPATH=src python -m repro_torch.core.sweep --expr aatb --grid smoke
    PYTHONPATH=src python -m repro_torch.core.sweep --expr aatb --grid smoke  # resumes: measured=0
    PYTHONPATH=src python -m repro_torch.core.sweep --expr abcd --grid 400,1200 --seed 0
    PYTHONPATH=src python -m repro_torch.core.sweep --backend cuda --device cpu --grid smoke
    PYTHONPATH=src python -m repro_torch.core.sweep --expr abab --grid 400,800,1200 --no-fusion
    PYTHONPATH=src python -m repro_torch.core.sweep --expr aatb --grid 400,800,1200 --mode predict
    PYTHONPATH=src python -m repro_torch.core.sweep --expr aatb --grid 400,800,1200 --mode evaluate --discriminants flops,perfmodel,measured
    PYTHONPATH=src python -m repro_torch.core.sweep --list-exprs
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
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

from ..kernels import _build
from ..kernels import ops as kops
from .algorithms import Algorithm, Leaf
from .anomaly import (Classification, ConfusionMatrix, Region, classify,
                      cluster_regions, region_summary)
from .backends import get_backend, register_torch_backends
from .backends.torch_backend import fusion_enabled
from .expressions import (REGISTRY, SWEEP_GRIDS, ExpressionSpec, GridSpec, get_spec,
                          registered_names)
from .fingerprint import HardwareFingerprint, cache_base_dir
from .flops import KernelCall
from .perfmodel import KernelProfile, TableProfile, predict_algorithm_time

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

    Beyond the reference's header keys, the header names the program that
    measured: ``kernels``, the hash of the CUDA kernel sources
    (:func:`repro_torch.kernels._build.source_hash`; None for the
    ``torch`` backend), and ``fusion``, whether fused dispatch was on. A
    resume under other kernel sources or the other fusion setting, or of
    an atlas whose header lacks either key, is refused: one atlas never
    mixes two programs' timings.

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
        cuda = fingerprint.backend == "cuda"
        self.program = {"kernels": _build.source_hash() if cuda else None,
                        "fusion": cuda and fusion_enabled()}
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
            **self.program,
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
            if not self.program.keys() <= head.keys():
                raise AtlasError(
                    f"atlas {self.path} does not record the kernel sources "
                    f"and the fusion setting it was measured with; start a "
                    f"fresh atlas (another --atlas-dir, or delete it)")
            recorded = {key: head[key] for key in self.program}
            if recorded != self.program:
                raise AtlasError(
                    f"atlas {self.path} was measured with kernels="
                    f"{recorded['kernels']!r} fusion={recorded['fusion']!r}, "
                    f"but this process runs kernels="
                    f"{self.program['kernels']!r} fusion="
                    f"{self.program['fusion']!r}")
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


def cluster_predictions(
    predicted: Mapping[Tuple[int, ...], Classification],
    grid: GridSpec,
) -> List[Region]:
    """Cluster predicted (model-only) classifications over a grid."""
    scores = {p: (c.time_score, c.flop_score)
              for p, c in predicted.items() if c.is_anomaly}
    return cluster_regions(scores, grid.axes)


# --------------------------------------------- batched kernel measurement ---

#: Bytes per element the models charge: both backends measure float32.
DTYPE_BYTES = 4


def collect_unique_calls(
    spec: ExpressionSpec, points: Iterable[Sequence[int]],
) -> List[KernelCall]:
    """Distinct kernel calls across every algorithm of every point.

    Across a grid, neighbouring instances' algorithms share most calls, so
    the unique set is far smaller than the naive call stream — this dedup
    is what makes predicted sweeps (and Experiment 3) cheap.
    """
    seen: Dict[KernelCall, None] = {}
    for p in points:
        for a in spec.algorithms(p):
            for call in a.calls:
                seen.setdefault(call)
    return list(seen)


def benchmark_unique_calls(
    runner,
    calls: Iterable[KernelCall],
    profile: Optional[TableProfile] = None,
    reps: Optional[int] = None,
    progress: Optional[Callable[[int, int, KernelCall], None]] = None,
) -> Tuple[TableProfile, int, int]:
    """Benchmark the deduplicated call set, reusing ``profile`` entries.

    Returns ``(profile, n_measured, n_reused)``. Calls the profile already
    covers are never re-measured — so a persisted calibration makes repeat
    sweeps nearly free, and every new measurement lands in the profile for
    the *next* consumer (the calibration-cache feedback loop). Each call
    is timed in isolation by ``runner.benchmark_call`` (one synthetic
    one-step algorithm: a warm-up and ``reps`` timed runs).
    """
    calls = list(dict.fromkeys(calls))
    if profile is None:
        profile = TableProfile(peak_flops=1.0)
    n_measured = n_reused = 0
    n_calls = len(calls)
    for i, call in enumerate(calls):
        if call in profile:
            n_reused += 1
            continue
        seconds = runner.benchmark_call(call, reps=reps)
        profile.record(call, seconds)
        n_measured += 1
        if seconds > 0 and call.flops:
            # cached profiles included: a newly observed best throughput
            # raises peak_flops so efficiency stays a true fraction
            profile.observe_peak(call.flops / seconds)
        if progress is not None:
            progress(i + 1, n_calls, call)
    return profile, n_measured, n_reused


def predict_classifications(
    spec: ExpressionSpec,
    points: Iterable[Sequence[int]],
    profile: KernelProfile,
    threshold: float = 0.10,
    dtype_bytes: int = DTYPE_BYTES,
) -> Dict[Tuple[int, ...], Classification]:
    """Classify every point from the additive per-kernel model (no timing).

    This is the paper's Experiment-3 prediction generalized to arbitrary
    point sets: with a calibrated profile it maps anomaly regions at grid
    scale in milliseconds. The model sums ``alg.calls``, one term per
    step, also where the ``cuda`` backend runs two steps as one fused
    kernel.
    """
    out: Dict[Tuple[int, ...], Classification] = {}
    for p in points:
        p = tuple(int(x) for x in p)
        algos = spec.algorithms(p)
        times = {a.name: predict_algorithm_time(a.calls, profile, dtype_bytes)
                 for a in algos}
        flops = {a.name: a.flops for a in algos}
        out[p] = classify(times, flops, threshold=threshold)
    return out


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


def _registry_epilog() -> str:
    """The family, discriminant, backend and analysis-rule registries,
    generated when the parser is built so the help text never omits an
    entry."""
    from .cli_help import (analysis_rules_epilog, backends_epilog,
                           discriminants_epilog)

    lines = ["registered expression families (repro_torch.core.expressions):"]
    for cli_name in registered_names():
        s = REGISTRY[cli_name]
        lines.append(f"  {cli_name:<7} {s.name:<7} ndims={s.ndims}  "
                     f"{s.description}")
    return "\n".join(lines) + "\n\n" + discriminants_epilog() + "\n\n" \
        + backends_epilog() + "\n\n" + analysis_rules_epilog()


def _note(msg: str, quiet: bool) -> None:
    if not quiet:
        print(msg, file=sys.stderr)
        sys.stderr.flush()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.sweep",
        description="Measured anomaly sweep over a problem-size grid on "
                    "the PyTorch port; results persist in the resumable "
                    "anomaly atlas.",
        epilog=_registry_epilog(),
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--expr", choices=registered_names(), default="aatb",
                    help="expression family to sweep (see the registry "
                         "listing below)")
    ap.add_argument("--list-exprs", action="store_true",
                    help="print the registered expression families (one "
                         "CLI name per line) and exit")
    ap.add_argument("--grid", default="small",
                    help=f"named grid {sorted(SWEEP_GRIDS)} or "
                         "comma-separated axis values, e.g. 400,800,1200")
    ap.add_argument("--mode", choices=("measure", "predict", "evaluate"),
                    default="measure",
                    help="measure: time every algorithm per instance; "
                         "predict: classify from per-kernel benchmarks "
                         "timed in isolation (additive model; feeds the "
                         "profile cache); evaluate: replay the persisted "
                         "atlas and score discriminants (top-1 accuracy, "
                         "time regret, anomaly recall/precision) without "
                         "timing anything")
    ap.add_argument("--discriminants", default=None, metavar="A,B,C",
                    help="comma-separated repro_torch.core.discriminants "
                         "registry keys to score in --mode evaluate "
                         "(default: every registered discriminant)")
    ap.add_argument("--backend", choices=("cuda", "torch"), default="cuda",
                    help="cuda: the hand-written kernels; torch: plain ATen")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu, "
                         "where the kernels' plain versions run")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-fusion", action="store_true",
                    help="cuda: disable fused adjacent-step dispatch (sets "
                         "REPRO_NO_FUSION) — every step launches its own "
                         "kernel")
    ap.add_argument("--seed", type=int, default=None,
                    help="operand-synthesis seed: every leaf becomes a "
                         "pure function of (seed, base, shape)")
    ap.add_argument("--threshold", type=float, default=0.10)
    ap.add_argument("--atlas-dir", type=Path, default=None,
                    help="atlas directory (default: $REPRO_ATLAS_DIR or "
                         "~/.cache/repro/atlas)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.list_exprs:
        for cli_name in registered_names():
            print(cli_name)
        return 0
    if args.discriminants and args.mode != "evaluate":
        # Scoring is a replay-only concern; silently accepting the flag
        # on a measured sweep would imply the sweep was somehow filtered.
        ap.error("--discriminants only applies to --mode evaluate")
    # Process-wide on purpose, as in the reference: the walker reads it at
    # every dispatch.
    if args.no_fusion:
        os.environ["REPRO_NO_FUSION"] = "1"

    spec = get_spec(args.expr)
    try:
        grid = parse_grid(spec, args.grid)
    except ValueError as e:
        ap.error(str(e))
    if args.mode == "evaluate":
        return _main_evaluate(args, spec, grid)
    register_torch_backends()
    runner = get_backend(args.backend, device=args.device, reps=args.reps,
                         seed=args.seed)
    fp = runner.fingerprint()
    atlas = AnomalyAtlas(atlas_path(spec.name, fp, args.threshold,
                                    args.atlas_dir),
                         fp, spec.name, args.threshold)
    _note(f"sweep {spec.name} grid={grid.name} ({grid.n_points} "
          f"instances over {spec.ndims} dims), backend={args.backend} "
          f"on {fp.device}; atlas {atlas.path} ({len(atlas)} already "
          f"recorded)", args.quiet)
    if args.mode == "predict":
        return _main_predict(args, spec, grid, runner, atlas)

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


def _main_predict(args, spec, grid, runner, atlas) -> int:
    """--mode predict: per-kernel benchmarks → model-only sweep."""
    from .profile_store import load_default_profile, save_profile

    points = grid.points()
    cached = load_default_profile(backend=args.backend, dtype=runner.dtype,
                                  device=args.device)
    calls = collect_unique_calls(spec, points)
    kops.reset_launch_counts()
    t0 = _time.perf_counter()
    profile, n_meas, n_reused = benchmark_unique_calls(
        runner, calls, profile=cached, reps=args.reps)
    bench_s = _time.perf_counter() - t0
    save_profile(profile, atlas.fingerprint,
                 meta={"source": f"sweep:{spec.name}"})
    predicted = predict_classifications(
        spec, points, profile, threshold=args.threshold,
        dtype_bytes=DTYPE_BYTES)
    n_anom = sum(1 for c in predicted.values() if c.is_anomaly)
    print(f"predict {spec.name}/{grid.name}: points={len(points)} "
          f"unique_kernels={len(calls)} measured={n_meas} "
          f"reused={n_reused} in {bench_s:.1f}s; "
          f"predicted anomalies={n_anom} ({n_anom / len(points):.1%})")
    print("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in kops.launch_counts().items()))
    print(region_summary(cluster_predictions(predicted, grid), len(points)))
    if len(atlas):
        # Confusion vs whatever ground truth the atlas already holds.
        cm = ConfusionMatrix()
        for p, c in predicted.items():
            actual = atlas.get(p)
            if actual is not None:
                cm.add(actual.cls.is_anomaly, c.is_anomaly)
        if cm.total:
            print(f"vs atlas ground truth ({cm.total} instances): "
                  f"recall={cm.recall:.1%} precision={cm.precision:.1%}")
    return 0


def _main_evaluate(args, spec, grid) -> int:
    """--mode evaluate: replay the atlas, score discriminants, no timing.

    The atlas is loaded through the *lenient* replay loader
    (:func:`repro_torch.core.evaluate.load_atlas_records`): evaluation
    never appends, so fingerprints are not matched against this process.
    If the fingerprint-exact file is absent but exactly one atlas for this
    (spec, threshold) exists — e.g. ground truth swept on another machine
    — that one is used, with a note. Profile-consuming policies read the
    profile cached for this backend and device, if any.
    """
    from .backends import get_backend_class
    from .discriminants import registered_discriminants
    from .evaluate import evaluate_discriminants, load_atlas_records
    from .profile_store import current_fingerprint, load_default_profile

    if args.discriminants:
        names = [n.strip() for n in args.discriminants.split(",")
                 if n.strip()]
        unknown = [n for n in names if n.lower()
                   not in registered_discriminants()]
        if unknown:
            print(f"unknown discriminant(s) {unknown}; registered: "
                  f"{registered_discriminants()}", file=sys.stderr)
            return 2
    else:
        names = registered_discriminants()

    register_torch_backends()
    dtype = get_backend_class(args.backend).default_dtype
    fp = current_fingerprint(backend=args.backend, dtype=dtype,
                             device=args.device)
    path = atlas_path(spec.name, fp, args.threshold, args.atlas_dir)
    if not path.is_file():
        t = f"{args.threshold:g}".replace(".", "p")
        candidates = [
            c for c in sorted(path.parent.glob(
                f"atlas-{_slug(spec.name)}-t{t}-*.jsonl"))
            # Un-merged shard files (the reference's fanned-out sweeps)
            # are partial by construction; replay a merged atlas instead.
            if not re.search(r"-shard\d+$", c.stem)
        ]
        if len(candidates) == 1:
            _note(f"no atlas for this fingerprint; evaluating the only "
                  f"match {candidates[0].name}", args.quiet)
            path = candidates[0]
        else:
            hint = (f"{len(candidates)} atlases match this spec/threshold"
                    if candidates else "none exist")
            print(f"no atlas at {path} ({hint}); sweep ground truth first: "
                  f"python -m repro_torch.core.sweep --expr {args.expr} "
                  f"--grid {args.grid} --backend {args.backend} --device "
                  f"{args.device}", file=sys.stderr)
            return 2

    replay = load_atlas_records(path)
    want = set(grid.points())
    records = [r for r in replay.records if r.point in want]
    if not records:
        # Grid mismatch (or a random-search atlas): score what exists
        # rather than erroring — the atlas is the ground truth we have.
        _note(f"no atlas records on grid {grid.name}; evaluating all "
              f"{len(replay.records)} recorded instances", args.quiet)
        records = replay.records
    if not records:
        print(f"atlas {path} holds no instances", file=sys.stderr)
        return 2

    profile = load_default_profile(backend=args.backend, dtype=dtype,
                                   device=args.device)
    try:
        res = evaluate_discriminants(
            spec, records, [n.lower() for n in names], profile=profile,
            threshold=args.threshold, dtype_bytes=DTYPE_BYTES)
    except ValueError as e:
        # Record-level defect (atlas swept under a different enumeration):
        # every row would be wrong, so the evaluation itself fails.
        print(f"evaluation failed: {e}", file=sys.stderr)
        return 1
    rows = []
    for score in res.scores.values():
        row = score.row()
        if score.error is not None and score.error.startswith("KeyError"):
            # The documented partial-calibration failure mode; other
            # errors get no hint — switching discriminants won't fix them.
            row += " (hint: `hybrid` tolerates partial calibrations)"
        rows.append(row)
    if all(s.error is not None for s in res.scores.values()):
        print("every requested discriminant failed to evaluate:",
              file=sys.stderr)
        for row in rows:
            print("  " + row, file=sys.stderr)
        return 1
    legacy = " legacy-fingerprint" if replay.legacy else ""
    print(f"evaluate {spec.name}/{grid.name} [{args.backend}]: "
          f"instances={res.n_instances} anomalies={res.n_anomalies} "
          f"profile={'cached' if profile is not None else 'analytical'}"
          f"{legacy}")
    for row in rows:
        print("  " + row)
    print(f"atlas read from {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
