"""The discriminant registry — selection policies as pluggable entries.

The port's counterpart of the reference package's
``core/discriminants.py``: the same registry, protocol and six policies.
On the port, measurement runs on the ``cuda`` backend by default, the
analytical model is :class:`~repro_torch.core.perfmodel
.AnalyticalHopperProfile` and the roofline's constants are the H100's
(:data:`~repro_torch.core.perfmodel.H100_SXM`), and every model charges
4-byte (float32) elements.

A *discriminant* ranks the mathematically equivalent algorithms of one
expression instance. The paper evaluates FLOP count as a discriminant and
finds it unreliable in contiguous regions of the problem-size space; its
conclusion — "combining FLOP counts with kernel performance models will
significantly improve our ability to choose optimal algorithms" — and the
follow-up by Sankaran & Bientinesi (ranking from cheap *relative*
measurements) are both selection policies. This module makes the policy
axis pluggable, the same way :mod:`repro_torch.core.backends` made the
executor axis pluggable and :mod:`repro_torch.core.expressions` the
expression axis:

* :class:`Discriminant` — the protocol: ``rank(algos, ctx)`` plus the
  capability flags ``requires_profile`` (ranking consults
  ``ctx.profile``) and ``requires_measurement`` (ranking executes on an
  execution backend). The flags let callers reject meaningless argument
  combinations loudly (a profile handed to ``flops`` used to be silently
  ignored) and let the planner skip profile-generation invalidation for
  policies whose ranking can never change with the profile.
* :class:`DiscriminantContext` — everything a policy may consult:
  profile, runner/backend, dtype width, and (for atlas replay —
  :mod:`repro_torch.core.evaluate`) pre-recorded per-algorithm times that stand
  in for live measurement.
* :func:`register_discriminant` / :func:`get_discriminant` /
  :func:`registered_discriminants` — the registry ``selector.select``,
  the planner, the sweep CLI (``--mode evaluate --discriminants``) and
  the evaluation scoreboard resolve policies through.

Six entries ship:

====================  =========================================================
``flops``             min FLOP count (paper baseline; Linnea/Julia/Armadillo)
``perfmodel``         Σ predicted per-kernel time under the given profile
``hybrid``            perfmodel over the table-∨-analytical hybrid coercion
``roofline``          memory-traffic roofline max(flops/peak, bytes/bw) — no
                      tile quantization, no profile; sees the zero-FLOP
                      TRI2FULL traffic that FLOPs cannot
``measured``          deduplicated per-kernel measurement on a backend
``rankk``             Sankaran-style budget-limited ranking: measure only the
                      top-k FLOPs candidates, rescale the model for the rest
====================  =========================================================

Every policy also exposes ``predict_times`` — the per-algorithm "times"
its ranking is the argsort of. That is what generalizes Experiment 3 into
a first-class API: a predicted classification (anomaly or not) can be
computed for *any* discriminant and scored against atlas ground truth
(:mod:`repro_torch.core.evaluate`). For ``flops`` the predicted time IS the
FLOP count — literally the paper's premise — so its predicted fastest set
always equals its cheapest set and it can never predict an anomaly.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Mapping, Optional, Sequence

from .algorithms import Algorithm
from .perfmodel import (
    H100_SXM,
    AnalyticalHopperProfile,
    HybridProfile,
    KernelProfile,
    RooflineProfile,
    TableProfile,
    predict_algorithm_time,
)

# ----------------------------------------------------------------- context --

#: Process-wide default runners for measurement-backed discriminants, one
#: per registry name, built once per process.
_SHARED_RUNNERS: Dict[str, object] = {}
_SHARED_LOCK = threading.Lock()


def shared_runner(name: str):
    """The process-wide default backend instance for ``name`` (cached)."""
    key = name.lower()
    with _SHARED_LOCK:
        runner = _SHARED_RUNNERS.get(key)
        if runner is None:
            from .backends import get_backend, register_torch_backends

            register_torch_backends()
            runner = get_backend(key, reps=3)
            _SHARED_RUNNERS[key] = runner
        return runner


@dataclasses.dataclass
class DiscriminantContext:
    """Everything a discriminant may consult while ranking.

    ``times`` is the replay channel: when set (atlas evaluation), it maps
    algorithm name -> measured seconds and stands in for live execution,
    so measurement-backed policies (``measured``, ``rankk``) can be
    scored against persisted ground truth without re-running anything.
    """

    profile: Optional[KernelProfile] = None
    runner: object = None
    backend: Optional[str] = None
    dtype_bytes: int = 4
    times: Optional[Mapping[str, float]] = None
    reps: Optional[int] = None

    def resolve_runner(self):
        """Explicit runner ∨ named backend ∨ the shared ``cuda`` default
        (on the card: it raises without one)."""
        if self.runner is not None:
            return self.runner
        return shared_runner(self.backend or "cuda")

    def measure(self, algos: Sequence[Algorithm]) -> Dict[str, float]:
        """Per-algorithm seconds: replayed, or dedup-benchmarked live.

        The live path routes through
        :func:`repro_torch.core.sweep.benchmark_unique_calls`: kernel calls
        shared across algorithms (most of them — sibling algorithms share
        long call prefixes) are timed once, and each algorithm's time is
        the additive model over its own *measured* entries.
        """
        if self.times is not None:
            return {a.name: float(self.times[a.name]) for a in algos}
        from .sweep import benchmark_unique_calls

        runner = self.resolve_runner()
        table, _, _ = benchmark_unique_calls(
            runner, [c for a in algos for c in a.calls],
            profile=TableProfile(peak_flops=1.0), reps=self.reps)
        return {a.name: sum(table.time(c) for c in a.calls) for a in algos}


# ---------------------------------------------------------------- protocol --


class Discriminant:
    """One selection policy: rank algorithms best-first.

    Capability flags (consulted by :func:`validate_arguments`, the
    selector shim and the planner):

    * ``requires_profile`` — the ranking consults ``ctx.profile`` (a
      missing profile may still default to the analytical model; the flag
      says a profile is *meaningful*, not mandatory).
    * ``requires_measurement`` — the ranking executes kernels on an
      execution backend (``ctx.runner``/``ctx.backend``), or replays
      recorded times through ``ctx.times``.

    Subclasses implement :meth:`predict_times` (the per-algorithm scores
    the ranking sorts by) and inherit :meth:`rank`; a policy whose order
    is not an argsort of scalar scores overrides :meth:`rank` directly
    and may return ``None`` from :meth:`predict_times`.
    """

    name: str = "abstract"
    requires_profile: bool = False
    requires_measurement: bool = False

    def fingerprint(self) -> str:
        """Identity for memo keys (parametrized policies extend this)."""
        return self.name

    def predict_times(self, algos: Sequence[Algorithm],
                      ctx: DiscriminantContext) -> Optional[Dict[str, float]]:
        """Per-algorithm predicted seconds (or score standing in for them).

        ``None`` means the policy has no per-algorithm scores (pure
        ordering); such a policy cannot predict anomaly classifications
        and is skipped by the recall/precision columns of the evaluation
        scoreboard.
        """
        return None

    def rank(self, algos: Sequence[Algorithm],
             ctx: DiscriminantContext) -> List[Algorithm]:
        """Best-first ranking; FLOPs then name break score ties."""
        times = self.predict_times(algos, ctx)
        if times is None:
            raise NotImplementedError(
                f"discriminant {self.name!r} defines neither predict_times "
                f"nor rank")
        return sorted(algos,
                      key=lambda a: (times[a.name], a.flops, a.name))


def as_hybrid(profile: Optional[KernelProfile]) -> HybridProfile:
    """Coerce any profile into the hybrid (table ∨ analytical) policy.

    * ``HybridProfile``   → used as-is;
    * ``TableProfile``    → wrapped with an analytical fallback;
    * anything else/None  → empty table over the given (or default)
      analytical model, so every call falls through to analytical until
      online refinement records measurements.
    """
    if isinstance(profile, HybridProfile):
        return profile
    if isinstance(profile, TableProfile):
        return HybridProfile(profile)
    analytical = profile or AnalyticalHopperProfile()
    return HybridProfile(TableProfile(peak_flops=analytical.peak()),
                         analytical=analytical)


# ----------------------------------------------------------- the policies --


class FlopsDiscriminant(Discriminant):
    """Paper-faithful baseline: ascending FLOP count, ties by name.

    ``predict_times`` returns the FLOP counts themselves — "FLOPs as the
    time estimate" is literally the premise the paper interrogates. Its
    predicted fastest set therefore always equals its cheapest set, so
    this policy can never predict an anomaly (scoreboard recall 0 by
    construction whenever anomalies exist).
    """

    name = "flops"

    def predict_times(self, algos, ctx):
        return {a.name: float(a.flops) for a in algos}


class PerfModelDiscriminant(Discriminant):
    """Ascending Σ predicted per-kernel time under the profile *as given*.

    ``None`` falls back to the analytical model of the port's kernels on
    the H100 (:class:`~repro_torch.core.perfmodel
    .AnalyticalHopperProfile`). A bare,
    partially calibrated :class:`TableProfile` may raise ``KeyError`` on
    kernel kinds it has never seen — use ``hybrid`` when the calibration
    may be partial.
    """

    name = "perfmodel"
    requires_profile = True

    def _profile(self, ctx: DiscriminantContext) -> KernelProfile:
        return ctx.profile or AnalyticalHopperProfile()

    def predict_times(self, algos, ctx):
        prof = self._profile(ctx)
        return {a.name: predict_algorithm_time(a.calls, prof,
                                               ctx.dtype_bytes)
                for a in algos}


class HybridDiscriminant(PerfModelDiscriminant):
    """Perfmodel over :func:`as_hybrid` coercion — measured table entries
    where a calibration has them (exactly or by near nearest-neighbour),
    analytical fallback elsewhere, so partial calibrations still rank
    every candidate."""

    name = "hybrid"

    def _profile(self, ctx: DiscriminantContext) -> KernelProfile:
        return as_hybrid(ctx.profile)


class RooflineDiscriminant(Discriminant):
    """Memory-traffic-aware analytical ranking (no profile, no tiles).

    Scores each call ``max(flops / peak, bytes·dtype / bandwidth)`` via
    :class:`~repro_torch.core.perfmodel.RooflineProfile`, by default at
    the H100's FP32 and HBM rates — the simplest model that still charges
    the zero-FLOP TRI2FULL copies and SYRK's halved output traffic.
    Deliberately distinct from ``perfmodel``'s default analytical model
    (block quantization over the SMs + per-call overhead): the two
    disagree exactly where quantization and host overhead dominate.
    """

    name = "roofline"

    def __init__(self, profile: Optional[RooflineProfile] = None):
        self._roofline = profile or RooflineProfile(H100_SXM)

    def predict_times(self, algos, ctx):
        return {a.name: predict_algorithm_time(a.calls, self._roofline,
                                               ctx.dtype_bytes)
                for a in algos}


class MeasuredDiscriminant(Discriminant):
    """Ground truth: ascending measured time on an execution backend.

    Measurement is deduplicated per kernel call
    (:meth:`DiscriminantContext.measure`): sibling algorithms share most
    of their calls, so each distinct ``(kind, dims)`` is timed once and
    algorithm times are additive over measured entries. Only affordable
    offline, or via the replay channel during atlas evaluation.
    """

    name = "measured"
    requires_measurement = True

    def predict_times(self, algos, ctx):
        return ctx.measure(algos)


class RankKDiscriminant(Discriminant):
    """Budget-limited relative-measurement ranking (Sankaran-style).

    Sankaran & Bientinesi rank algorithms from cheap *relative*
    measurements instead of exhaustive timing. This policy spends its
    measurement budget on the ``k`` FLOP-cheapest candidates only (the
    set FLOPs says should contain the winner — and where the paper shows
    it is most dangerously wrong), then rescales the model's predictions
    for the remaining candidates by the median measured/modelled ratio
    over the measured set, so every algorithm lands on one comparable
    time axis. ``k >= len(algos)`` degrades to ``measured``; ``k == 0``
    would degrade to ``hybrid`` (and is rejected).
    """

    name = "rankk"
    requires_profile = True
    requires_measurement = True

    def __init__(self, k: int = 3):
        if k < 1:
            raise ValueError("rankk needs a measurement budget k >= 1")
        self.k = k

    def fingerprint(self) -> str:
        return f"{self.name}(k={self.k})"

    def predict_times(self, algos, ctx):
        by_flops = sorted(algos, key=lambda a: (a.flops, a.name))
        top = by_flops[:self.k]
        measured = ctx.measure(top)
        prof = as_hybrid(ctx.profile)
        model = {a.name: predict_algorithm_time(a.calls, prof,
                                                ctx.dtype_bytes)
                 for a in algos}
        ratios = sorted(measured[a.name] / model[a.name] for a in top
                        if model[a.name] > 0 and measured[a.name] > 0)
        scale = ratios[len(ratios) // 2] if ratios else 1.0
        return {a.name: measured.get(a.name, model[a.name] * scale)
                for a in algos}


# ---------------------------------------------------------------- registry --

_REGISTRY: Dict[str, Discriminant] = {}


def register_discriminant(disc: Discriminant,
                          name: Optional[str] = None) -> Discriminant:
    """Register a policy instance under ``name`` (default ``disc.name``).

    Returns ``disc`` (declaration style). Duplicate names are rejected:
    silently shadowing ``flops`` would re-define the paper baseline every
    atlas evaluation is scored against.
    """
    key = (name or disc.name).lower()
    if key in _REGISTRY:
        raise ValueError(f"discriminant {key!r} is already registered")
    _REGISTRY[key] = disc
    return disc


def get_discriminant(name: str) -> Discriminant:
    """Resolve a registry name to its policy instance."""
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown discriminant {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def registered_discriminants() -> List[str]:
    return sorted(_REGISTRY)


def validate_arguments(disc: Discriminant,
                       profile: Optional[KernelProfile] = None,
                       runner: object = None,
                       backend: Optional[str] = None) -> None:
    """Reject argument combinations the policy would silently ignore.

    The capability flags make "this argument is meaningless here" a
    property of the policy instead of folklore: a profile handed to
    ``flops``/``measured`` or a runner handed to ``flops``/``perfmodel``
    used to be dropped on the floor — now it raises, naming the flag.
    """
    if runner is not None and backend is not None:
        raise ValueError("pass either runner= or backend=, not both")
    if profile is not None and not disc.requires_profile:
        raise ValueError(
            f"discriminant {disc.name!r} does not consult a profile "
            f"(requires_profile=False); the profile= argument would be "
            f"silently ignored")
    if (runner is not None or backend is not None) \
            and not disc.requires_measurement:
        raise ValueError(
            f"discriminant {disc.name!r} never executes kernels "
            f"(requires_measurement=False); the "
            f"{'runner=' if runner is not None else 'backend='} argument "
            f"would be silently ignored")


register_discriminant(FlopsDiscriminant())
register_discriminant(PerfModelDiscriminant())
register_discriminant(HybridDiscriminant())
register_discriminant(RooflineDiscriminant())
register_discriminant(MeasuredDiscriminant())
register_discriminant(RankKDiscriminant())
