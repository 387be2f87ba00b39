"""The paper's three experiments (§3.4), as thin harnesses over the engine.

The port's counterpart of the reference package's ``core/experiments.py``:

* Experiment 1 — random search over an instance box: abundance + severity.
* Experiment 2 — axis-aligned line traversal around found anomalies: region
  thickness per dimension.
* Experiment 3 — predict anomalies from *isolated* kernel benchmarks
  (additive model), confusion matrix vs measured ground truth.

All measurement goes through :func:`repro_torch.core.sweep.sweep` and
:func:`~repro_torch.core.sweep.measure_instance` — the one measurement
path shared with grid sweeps — on an execution backend (``exec_backend``,
a registry name, by default ``cuda``, the hand-written kernels on the
card; ``blas`` is the reference's default, the paper's float64 BLAS
protocol on the host; or an instance as ``runner``). Experiment 1 runs
on any engine of the sweep (``backend``): ``"serial"`` in this process,
``"process"`` over one pool of spawned worker processes for the whole
search (the fan-out of ``blas`` and ``numpy``), or ``"devices"``, one
process per card. Every harness can stream into a persistent
:class:`~repro_torch.core.sweep.AnomalyAtlas` (``atlas=``) so repeated
runs resume instead of re-measure. Experiment 3's isolated kernel
benchmarks are deduplicated and can start from a persisted profile
(:mod:`repro_torch.core.profile_store`).

Every harness takes any registered :class:`ExpressionSpec`, so the zoo
families run through Experiments 1–3 unchanged.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .anomaly import Classification, ConfusionMatrix, RegionScan, scan_line
from .arena import arena_for
from .backends import (ExecutionBackend, backend_on, backend_shard_mode,
                       register_torch_backends)
from .perfmodel import TableProfile
from .sweep import (
    AnomalyAtlas,
    ExpressionSpec,
    Instance,
    _spawn_pool,
    benchmark_unique_calls,
    card_devices,
    collect_unique_calls,
    element_bytes,
    fastpath_enabled,
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
    ``cuda``) built with its defaults, a device backend on ``device`` and
    a host backend on the host — one instance, so one flush buffer, for
    a whole experiment."""
    if runner is None or isinstance(runner, str):
        register_torch_backends()
        return backend_on(runner or "cuda", device)
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
    shards: Optional[int] = None,
    runner_factory: Optional[Callable[[], object]] = None,
    batch: int = 25,
    exec_backend: Optional[str] = None,
    device: str = "cuda",
) -> Experiment1Result:
    """Paper §3.4.1: sample instances u.a.r. until n anomalies are found.

    Sampling draws from ``np.random.default_rng(seed)`` in batches of
    ``batch`` points (the reference's sequence, point for point), so
    every engine draws the same points; the search stops at the end of
    the batch that reaches ``n_anomalies`` (it may slightly overshoot).
    Points already in ``atlas`` count as samples but are served from
    disk.

    ``backend`` is the engine: ``"serial"`` measures in this process with
    ``runner`` (an instance or a registry name), or one instance of
    ``exec_backend`` (default ``cuda``) on ``device`` built for the whole
    search; ``"process"`` shards each batch over one pool of ``shards``
    spawned workers that serves the entire search, each worker building
    its runner from ``runner_factory`` (picklable), or from
    ``exec_backend``; ``"devices"`` gives each card a worker process of
    its own, and on one card (or ``device="cpu"``) builds one
    ``exec_backend`` instance here. ``runner`` configures only the
    serial engine: with any other it raises, as in the reference.
    """
    rng = np.random.default_rng(seed)
    if runner is not None and backend != "serial":
        # the guard sweep() enforces: a runner's protocol (reps, cache
        # flushing) must not be silently swapped for worker defaults
        raise ValueError(
            f"runner= only configures the serial backend; backend="
            f"{backend!r} builds workers from runner_factory")
    if backend == "devices":
        register_torch_backends()
        if backend_shard_mode(exec_backend or "cuda") != "device":
            raise ValueError(
                f"backend='devices' fans a device backend out over cards; "
                f"{exec_backend!r} runs on the host (backend='process')")
        if len(card_devices(device, shards)) <= 1:
            # One device: the devices engine is the serial path; one
            # instance keeps its arena and graph memo for the search.
            backend = "serial"
    if backend == "serial" and runner_factory is None:
        runner = _runner(runner if runner is not None else exec_backend,
                         device)
    executor = None
    if backend == "process":
        executor = _spawn_pool(shards or os.cpu_count() or 1)
    found: List[Instance] = []
    samples = 0
    wall = 0.0
    try:
        while len(found) < n_anomalies and samples < max_samples:
            n = min(batch, max_samples - samples)
            pts = [tuple(int(x) for x in
                         rng.integers(box[0], box[1] + 1, size=spec.ndims))
                   for _ in range(n)]
            res = sweep(spec, pts, runner=runner,
                        runner_factory=runner_factory, threshold=threshold,
                        backend=backend, shards=shards, atlas=atlas,
                        executor=executor, exec_backend=exec_backend,
                        device=device)
            samples += res.n_points
            wall += res.wall_s
            for inst in res.records:
                if inst.cls.is_anomaly:
                    found.append(inst)
                    if verbose:
                        print(f"  anomaly #{len(found)} at {inst.point} "
                              f"ts={inst.cls.time_score:.1%} "
                              f"fs={inst.cls.flop_score:.1%}")
    finally:
        if executor is not None:
            executor.shutdown()
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
    exec_backend: Optional[str] = None,
    device: str = "cuda",
) -> Experiment2Result:
    """Paper §3.4.2: intersect regions with axis-aligned lines.

    Line traversal is inherently sequential (each probe decides the next),
    so this harness probes point by point with the engine's measurement
    primitive; with an ``atlas`` every probe is served from / buffered
    into it (chunk-flushed by the atlas, once more on return), so repeat
    traversals resume. Without a ``runner`` the probes run on one
    instance of ``exec_backend`` (default ``cuda``) on ``device``.
    """
    runner = _runner(runner if runner is not None else exec_backend, device)
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
    exec_backend: Optional[str] = None,
    device: str = "cuda",
) -> Experiment3Result:
    """Paper §3.4.3: benchmark each distinct kernel call in isolation, then
    predict each instance's fastest/cheapest sets from the additive model and
    compare against measured ground truth.

    ``runner`` is an execution-backend instance or a registry name; with
    ``runner=None`` the calls are timed on ``exec_backend`` (default
    ``cuda``) on ``device``. The model charges the measuring backend's
    element size (8 bytes for float64, as the reference's ``blas``). The
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

    runner = _runner(runner if runner is not None else exec_backend, device)
    # 1. Benchmark the deduplicated call set (reusing the profile), a
    # backend's operands from its shape-keyed arena as --mode predict
    # takes them (the fast path's; the same protocol either way).
    calls = collect_unique_calls(spec, classified)
    arena = arena_for(runner) if isinstance(runner, ExecutionBackend) \
        and fastpath_enabled() else None
    profile, n_meas, n_reused = benchmark_unique_calls(
        runner, calls, profile=profile, arena=arena)

    # 2. Score the additive model through the shared evaluation path.
    res = evaluate_discriminants(
        spec, list(classified.values()), ["perfmodel"],
        profile=profile, threshold=threshold,
        dtype_bytes=element_bytes(getattr(runner, "dtype", "float32")))
    cm = res.scores["perfmodel"].confusion

    return Experiment3Result(spec.name, cm, profile,
                             n_calls_measured=n_meas,
                             n_calls_reused=n_reused)
