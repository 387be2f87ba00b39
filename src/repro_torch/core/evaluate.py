"""Atlas replay: score every discriminant against persisted ground truth.

The port's counterpart of the reference package's ``core/evaluate.py``.
The anomaly atlas (:mod:`repro_torch.core.sweep`) records, per instance,
the measured time of *every* algorithm — which is exactly what is needed
to answer the question the paper leaves open: **which discriminant is
best, and by how much?** This module replays persisted atlases through
the discriminant registry (:mod:`repro_torch.core.discriminants`) and
scores each policy without re-measuring anything:

* **top-1 accuracy** — fraction of instances where the policy's first
  pick is a member of the fastest set (time ties resolved with the same
  ``rel_tol`` as classification);
* **time regret** (mean and p95) — relative wall time lost by the pick
  vs. the fastest algorithm (:func:`repro_torch.core.anomaly.pick_regret`);
* **anomaly recall / precision** — Experiment 3's confusion matrix
  (paper Tables 1–2: 75–92 % recall) generalized to *any* policy: each
  discriminant's ``predict_times`` yields a predicted classification that
  is scored against the ground-truth classification.

Measurement-backed policies (``measured``, ``rankk``) are replayed
through :class:`~repro_torch.core.discriminants.DiscriminantContext.times`
— the atlas's recorded times stand in for live execution, so ``measured``
scores a regret of exactly 0 on its own atlas.

Entry points: :func:`evaluate_discriminants` (records in hand),
:func:`evaluate_atlas` (a path or
:class:`~repro_torch.core.sweep.AnomalyAtlas`), and
``python -m repro_torch.core.sweep --mode evaluate --discriminants a,b,c``
(the CLI).

The loader reads either package's atlases: the port's header also names
its program (``kernels``, ``fusion``), which replay does not need.
Reference atlases written before its execution-backend registry existed
carry a fingerprint without a ``backend`` key; :func:`load_atlas_records`
normalizes such legacy headers (``backend="blas"``, the only executor
that existed then) instead of crashing.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .anomaly import ConfusionMatrix, classify, pick_regret
from .discriminants import (
    DiscriminantContext,
    get_discriminant,
    registered_discriminants,
)
from .expressions import ExpressionSpec, find_spec
from .perfmodel import KernelProfile
from .fingerprint import HardwareFingerprint
from .sweep import (
    ATLAS_SCHEMA_VERSION,
    AnomalyAtlas,
    AtlasError,
    Instance,
    _instance_from_json,
)

# ------------------------------------------------------------------ scores --


@dataclasses.dataclass
class DiscriminantScore:
    """One policy's scoreboard row over one replayed record set.

    ``error`` is set (and every metric zeroed) when the policy raised
    while scoring — e.g. ``perfmodel`` handed a partially calibrated
    table that ``KeyError``s on an unmeasured kernel kind. Per-policy
    failures never abort the scoreboard; defects in the *records* (an
    atlas swept under a different enumeration) still raise from
    :func:`evaluate_discriminants`, since they invalidate every row.
    """

    discriminant: str
    n_instances: int
    top1_hits: int
    regrets: Tuple[float, ...]
    confusion: Optional[ConfusionMatrix]
    error: Optional[str] = None

    @property
    def top1_accuracy(self) -> float:
        """Fraction of instances whose pick is in the fastest set."""
        return self.top1_hits / self.n_instances if self.n_instances else 0.0

    @property
    def mean_regret(self) -> float:
        return float(np.mean(self.regrets)) if self.regrets else 0.0

    @property
    def p95_regret(self) -> float:
        return float(np.percentile(self.regrets, 95)) if self.regrets \
            else 0.0

    @property
    def recall(self) -> Optional[float]:
        """Anomaly recall of the predicted classifications (None: the
        policy exposes no predicted times, so no classification exists)."""
        return self.confusion.recall if self.confusion is not None else None

    @property
    def precision(self) -> Optional[float]:
        return self.confusion.precision if self.confusion is not None \
            else None

    def row(self) -> str:
        if self.error is not None:
            return f"{self.discriminant:<10} failed: {self.error}"
        rec = f"{self.recall:.3f}" if self.recall is not None else "n/a"
        pre = f"{self.precision:.3f}" if self.precision is not None \
            else "n/a"
        return (f"{self.discriminant:<10} top1={self.top1_accuracy:.3f} "
                f"mean_regret={self.mean_regret:.1%} "
                f"p95_regret={self.p95_regret:.1%} "
                f"recall={rec} precision={pre}")


@dataclasses.dataclass
class EvaluationResult:
    """The scoreboard: every requested policy scored on one record set."""

    spec_name: str
    threshold: float
    n_instances: int
    n_anomalies: int
    scores: Dict[str, DiscriminantScore]

    def summary(self) -> str:
        lines = [f"evaluated {len(self.scores)} discriminants on "
                 f"{self.n_instances} instances of {self.spec_name} "
                 f"({self.n_anomalies} anomalies at "
                 f"threshold={self.threshold:g})"]
        for name in self.scores:
            lines.append("  " + self.scores[name].row())
        return "\n".join(lines)


def evaluate_discriminants(
    spec: ExpressionSpec,
    records: Sequence[Instance],
    discriminants: Optional[Sequence[str]] = None,
    *,
    profile: Optional[KernelProfile] = None,
    threshold: float = 0.10,
    dtype_bytes: int = 4,
) -> EvaluationResult:
    """Score discriminants against fully measured records — the core loop.

    ``records`` come from an atlas (or any :func:`~repro_torch.core.sweep.sweep`
    result): each carries every algorithm's measured time. Ground truth is
    re-classified from those raw times at ``threshold`` (so one atlas can
    be evaluated at a different threshold than it was swept with — the
    paper itself uses 10 % for Experiment 1 and 5 % for Experiment 3).
    ``profile`` feeds the profile-consuming policies; measurement-backed
    policies replay the recorded times instead of executing anything.

    Accuracy/regret score the pick of each policy's own :meth:`rank` —
    the ordering the planner would actually execute — while anomaly
    classification comes from its :meth:`predict_times`. A policy that
    raises while scoring (``perfmodel`` over a partial calibration) gets
    an ``error`` row instead of aborting the other policies; defects in
    the records themselves still raise, since every row would be wrong.
    """
    names = list(discriminants) if discriminants is not None \
        else registered_discriminants()
    # Dedupe, order-preserving: the per-name counters below are shared,
    # so a repeated name would double-count hits (top-1 accuracy > 1).
    names = list(dict.fromkeys(names))
    policies = dict(zip(names, (get_discriminant(n) for n in names)))
    hits = {n: 0 for n in names}
    regrets: Dict[str, List[float]] = {n: [] for n in names}
    confusion: Dict[str, Optional[ConfusionMatrix]] = {
        n: ConfusionMatrix() for n in names}
    failed: Dict[str, str] = {}
    n_anomalies = 0
    for inst in records:
        algos = spec.algorithms(inst.point)
        expected = {a.name for a in algos}
        got = set(inst.times)
        if expected != got:
            missing = sorted(expected - got)
            extra = sorted(got - expected)
            raise ValueError(
                f"record at {inst.point} "
                f"{'lacks times for ' + str(missing) if missing else ''}"
                f"{' and ' if missing and extra else ''}"
                f"{'has times for unknown ' + str(extra) if extra else ''} "
                f"— was the atlas swept with a different enumeration of "
                f"{spec.name}?")
        flops = {a.name: a.flops for a in algos}
        actual = classify(inst.times, flops, threshold=threshold)
        n_anomalies += actual.is_anomaly
        ctx = DiscriminantContext(profile=profile, dtype_bytes=dtype_bytes,
                                  times=inst.times)
        for name in names:
            if name in failed:
                continue
            d = policies[name]
            try:
                ranked = d.rank(algos, ctx)
                pred_times = d.predict_times(algos, ctx)
            except Exception as e:
                failed[name] = f"{type(e).__name__}: {e}"
                continue
            if pred_times is None:
                confusion[name] = None
            else:
                cm = confusion[name]
                if cm is not None:
                    predicted = classify(pred_times, flops,
                                         threshold=threshold)
                    cm.add(actual.is_anomaly, predicted.is_anomaly)
            pick = ranked[0].name
            hits[name] += pick in actual.fastest
            regrets[name].append(pick_regret(inst.times, pick))

    def _score(n: str) -> DiscriminantScore:
        if n in failed:
            return DiscriminantScore(
                discriminant=n, n_instances=len(records), top1_hits=0,
                regrets=(), confusion=None, error=failed[n])
        return DiscriminantScore(
            discriminant=n, n_instances=len(records),
            top1_hits=hits[n], regrets=tuple(regrets[n]),
            confusion=confusion[n])

    return EvaluationResult(
        spec_name=spec.name,
        threshold=float(threshold),
        n_instances=len(records),
        n_anomalies=n_anomalies,
        scores={n: _score(n) for n in names},
    )


# ----------------------------------------------------- atlas replay loading --


@dataclasses.dataclass
class AtlasReplay:
    """A persisted atlas loaded for evaluation (read-only, any machine's).

    Unlike :class:`~repro_torch.core.sweep.AnomalyAtlas`, no fingerprint match
    against *this* process is enforced — evaluation replays recorded
    times, it never appends — and legacy pre-backend-registry headers are
    normalized rather than rejected (``legacy`` records that this
    happened).
    """

    path: Path
    spec_name: str
    threshold: float
    fingerprint: HardwareFingerprint
    records: List[Instance]
    skipped_lines: int = 0
    legacy: bool = False


def _normalize_fingerprint(d: Optional[dict]) -> Tuple[HardwareFingerprint,
                                                       bool]:
    """Fingerprint from a header dict, tolerating pre-registry layouts.

    Atlases written before the execution-backend registry have no
    ``backend`` key (every sweep ran the scipy BLAS protocol then), and
    the earliest ones lack ``dtype`` too. Defaults reconstruct what those
    sweeps actually measured.
    """
    d = dict(d or {})
    legacy = "backend" not in d
    d.setdefault("backend", "blas")
    d.setdefault("device", "unknown")
    d.setdefault("dtype", "float64")
    return HardwareFingerprint.from_dict(d), legacy


def load_atlas_records(path: Union[str, Path]) -> AtlasReplay:
    """Read any atlas file for replay — tolerant where appending is strict.

    Torn tails are skipped (and counted) exactly as the resumable loader
    does; header fingerprints are normalized via
    :func:`_normalize_fingerprint` instead of being matched against this
    machine.
    """
    path = Path(path)
    records: List[Instance] = []
    skipped = 0
    with path.open() as f:
        try:
            head = json.loads(f.readline())
        except json.JSONDecodeError:
            raise AtlasError(f"atlas {path} has an unreadable header")
        if head.get("kind") != "header":
            raise AtlasError(f"atlas {path} is missing its header")
        if head.get("version") != ATLAS_SCHEMA_VERSION:
            raise AtlasError(
                f"atlas {path} has schema version {head.get('version')!r}; "
                f"this build reads {ATLAS_SCHEMA_VERSION}")
        fp, legacy = _normalize_fingerprint(head.get("fingerprint"))
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(_instance_from_json(json.loads(line)))
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                skipped += 1
    return AtlasReplay(
        path=path,
        spec_name=str(head.get("spec", "")),
        threshold=float(head.get("threshold", 0.10)),
        fingerprint=fp,
        records=records,
        skipped_lines=skipped,
        legacy=legacy,
    )


def evaluate_atlas(
    atlas: Union[str, Path, AnomalyAtlas, AtlasReplay],
    discriminants: Optional[Sequence[str]] = None,
    *,
    spec: Optional[ExpressionSpec] = None,
    profile: Optional[KernelProfile] = None,
    threshold: Optional[float] = None,
    dtype_bytes: int = 4,
    points: Optional[Sequence[Sequence[int]]] = None,
) -> EvaluationResult:
    """Replay one persisted atlas and score the requested discriminants.

    ``atlas`` is a path (loaded leniently — legacy headers normalize), an
    open :class:`AnomalyAtlas`, or a pre-loaded :class:`AtlasReplay`.
    ``spec`` defaults to resolving the atlas's recorded expression name
    through the zoo registry; ``threshold`` defaults to the atlas's own;
    ``points`` restricts evaluation to a subset (e.g. one grid) — points
    absent from the atlas are skipped.
    """
    if isinstance(atlas, (str, Path)):
        atlas = load_atlas_records(atlas)
    if isinstance(atlas, AnomalyAtlas):
        replay = AtlasReplay(
            path=atlas.path, spec_name=atlas.spec_name,
            threshold=atlas.threshold, fingerprint=atlas.fingerprint,
            records=atlas.records())
    else:
        replay = atlas
    if spec is None:
        spec = find_spec(replay.spec_name)
    records = replay.records
    if points is not None:
        want = {tuple(int(x) for x in p) for p in points}
        records = [r for r in records if r.point in want]
    return evaluate_discriminants(
        spec, records, discriminants,
        profile=profile,
        threshold=replay.threshold if threshold is None else threshold,
        dtype_bytes=dtype_bytes,
    )
