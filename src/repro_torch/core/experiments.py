"""The paper's three experiments (§3.4), as thin harnesses over the engine.

The port's counterpart of the reference package's ``core/experiments.py``:

* Experiment 1 — random search over an instance box: abundance + severity.
* Experiment 2 — axis-aligned line traversal around found anomalies: region
  thickness per dimension.
* Experiment 3 — predict anomalies from *isolated* kernel benchmarks
  (additive model), confusion matrix vs measured ground truth.

All measurement goes through :func:`repro_torch.core.sweep.sweep` and
:func:`~repro_torch.core.sweep.measure_instance` — the one measurement
path shared with grid sweeps — serially in this process, on an execution
backend (by default ``cuda``, the hand-written kernels on the card; a
registry name or an instance), and can stream into a persistent
:class:`~repro_torch.core.sweep.AnomalyAtlas` (``atlas=``) so repeated
runs resume instead of re-measure. Experiment 3's isolated kernel
benchmarks are deduplicated and can start from a persisted profile
(:mod:`repro_torch.core.profile_store`).

Every harness takes any registered :class:`ExpressionSpec`, so the zoo
families run through Experiments 1–3 unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .anomaly import Classification, ConfusionMatrix, RegionScan, scan_line
from .backends import ExecutionBackend, get_backend, register_torch_backends
from .perfmodel import TableProfile
from .sweep import (
    DTYPE_BYTES,
    AnomalyAtlas,
    ExpressionSpec,
    Instance,
    benchmark_unique_calls,
    collect_unique_calls,
    measure_instance,
    sweep,
)

__all__ = [
    "Experiment1Result", "Experiment2Result", "Experiment3Result",
    "experiment1_random_search", "experiment2_regions",
    "experiment3_predict_from_benchmarks",
]

Runner = Union[str, ExecutionBackend, None]


def _runner(runner: Runner, device: str) -> ExecutionBackend:
    """A backend instance: the one given, or a registry name (default
    ``cuda``) built on ``device`` — one instance for a whole experiment."""
    if runner is None or isinstance(runner, str):
        register_torch_backends()
        return get_backend(runner or "cuda", device=device)
    return runner


@dataclasses.dataclass
class Experiment1Result:
    spec_name: str
    samples: int
    anomalies: List[Instance]
    wall_s: float

    @property
    def abundance(self) -> float:
        return len(self.anomalies) / self.samples if self.samples else 0.0


def experiment1_random_search(
    spec: ExpressionSpec,
    runner: Runner = None,
    box: Tuple[int, int] = (20, 1200),
    n_anomalies: int = 20,
    max_samples: int = 2000,
    threshold: float = 0.10,
    seed: int = 0,
    verbose: bool = False,
    atlas: Optional[AnomalyAtlas] = None,
    backend: str = "serial",
    batch: int = 25,
    device: str = "cuda",
) -> Experiment1Result:
    """Paper §3.4.1: sample instances u.a.r. until n anomalies are found.

    Sampling draws from ``np.random.default_rng(seed)`` in batches of
    ``batch`` points (the reference's sequence, point for point); the
    search stops at the end of the batch that reaches ``n_anomalies`` (it
    may slightly overshoot). Points already in ``atlas`` count as samples
    but are served from disk.
    """
    if backend != "serial":
        raise ValueError(
            f"backend={backend!r}: the port measures serially in this "
            f"process (backend='serial'); a worker pool is not ported")
    rng = np.random.default_rng(seed)
    runner = _runner(runner, device)
    found: List[Instance] = []
    samples = 0
    wall = 0.0
    while len(found) < n_anomalies and samples < max_samples:
        n = min(batch, max_samples - samples)
        pts = [tuple(int(x) for x in
                     rng.integers(box[0], box[1] + 1, size=spec.ndims))
               for _ in range(n)]
        res = sweep(spec, pts, runner=runner, threshold=threshold,
                    atlas=atlas)
        samples += res.n_points
        wall += res.wall_s
        for inst in res.records:
            if inst.cls.is_anomaly:
                found.append(inst)
                if verbose:
                    print(f"  anomaly #{len(found)} at {inst.point} "
                          f"ts={inst.cls.time_score:.1%} "
                          f"fs={inst.cls.flop_score:.1%}")
    return Experiment1Result(spec.name, samples, found, wall)


@dataclasses.dataclass
class Experiment2Result:
    spec_name: str
    scans: List[RegionScan]
    # All classified points, reusable by Experiment 3:
    classified: Dict[Tuple[int, ...], Instance]


def experiment2_regions(
    spec: ExpressionSpec,
    runner: Runner = None,
    anomalies: Sequence[Instance] = (),
    box: Tuple[int, int] = (20, 1200),
    step: int = 10,
    threshold: float = 0.05,
    atlas: Optional[AnomalyAtlas] = None,
    device: str = "cuda",
) -> Experiment2Result:
    """Paper §3.4.2: intersect regions with axis-aligned lines.

    Line traversal is inherently sequential (each probe decides the next),
    so this harness probes point by point with the engine's measurement
    primitive; with an ``atlas`` every probe is served from / buffered
    into it (chunk-flushed by the atlas, once more on return), so repeat
    traversals resume.
    """
    runner = _runner(runner, device)
    classified: Dict[Tuple[int, ...], Instance] = {}

    def classify_at(point: Tuple[int, ...]) -> Classification:
        if point not in classified:
            hit = atlas.get(point) if atlas is not None else None
            if hit is None:
                hit = measure_instance(spec, point, runner, threshold)
                if atlas is not None:
                    atlas.append(hit)  # buffered: fsync per chunk, not probe
            classified[point] = hit
        return classified[point].cls

    scans: List[RegionScan] = []
    try:
        for inst in anomalies:
            for dim in range(spec.ndims):
                scans.append(scan_line(
                    classify_at, inst.point, dim, box[0], box[1],
                    step=step))
    finally:
        if atlas is not None:
            atlas.flush()
    return Experiment2Result(spec.name, scans, classified)


@dataclasses.dataclass
class Experiment3Result:
    spec_name: str
    confusion: ConfusionMatrix
    profile: TableProfile
    n_calls_measured: int = 0
    n_calls_reused: int = 0


def experiment3_predict_from_benchmarks(
    spec: ExpressionSpec,
    runner: Runner,
    classified: Dict[Tuple[int, ...], Instance],
    threshold: float = 0.05,
    peak_flops: float = 1e11,
    profile: Optional[TableProfile] = None,
    device: str = "cuda",
) -> Experiment3Result:
    """Paper §3.4.3: benchmark each distinct kernel call in isolation, then
    predict each instance's fastest/cheapest sets from the additive model and
    compare against measured ground truth.

    ``runner`` is an execution-backend instance or a registry name. The
    distinct-call set is collected across *all* instances up front and
    deduplicated (:func:`~repro_torch.core.sweep.benchmark_unique_calls`),
    so each (kind, dims) is timed at most once. Pass a persisted
    ``profile`` to reuse prior calibrations: only calls it lacks are
    measured, and the entries added here flow back through the result.

    Scoring is the discriminant scoreboard
    (:func:`repro_torch.core.evaluate.evaluate_discriminants`): the
    experiment *is* "evaluate the ``perfmodel`` discriminant, armed with
    the benched table, against measured ground truth". The additive model
    sums one term per step, also where the ``cuda`` backend ran two steps
    as one fused kernel, as the reference does.
    """
    from .evaluate import evaluate_discriminants

    if profile is None:
        profile = TableProfile(peak_flops=peak_flops)

    # 1. Benchmark the deduplicated call set (reusing the profile).
    calls = collect_unique_calls(spec, classified)
    profile, n_meas, n_reused = benchmark_unique_calls(
        _runner(runner, device), calls, profile=profile)

    # 2. Score the additive model through the shared evaluation path.
    res = evaluate_discriminants(
        spec, list(classified.values()), ["perfmodel"],
        profile=profile, threshold=threshold, dtype_bytes=DTYPE_BYTES)
    cm = res.scores["perfmodel"].confusion

    return Experiment3Result(spec.name, cm, profile,
                             n_calls_measured=n_meas,
                             n_calls_reused=n_reused)
