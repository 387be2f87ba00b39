"""The planner: expression → selected algorithm → callable on the card.

The port's counterpart of the reference package's ``core/planner.py``,
the paper's contribution as a *runtime feature*: model code hands a
linear-algebra expression (chain, Gram product) plus concrete sizes to
:func:`plan`, and gets back a callable implementing the algorithm the
configured discriminant ranks first — on the ``cuda`` backend, a walk of
the hand-written kernels (under the tuning table's launches). Plans are
memoised per (expression structure, sizes, discriminant, profile
generation), so planning is paid once per shape.

Profiles resolve in three tiers:

1. an explicit ``profile=`` argument wins;
2. otherwise a persisted calibration of this card is loaded from the
   profile cache (:mod:`repro_torch.core.profile_store`) and wrapped in
   the hybrid measured-∨-analytical policy;
3. otherwise :class:`~repro_torch.core.perfmodel.AnalyticalHopperProfile`,
   the port's kernels' own launch models.

With ``record=True`` the planner refines the live profile online: each
``planner(chain, *tensors)`` execution is timed to its completion on the
card (:func:`~repro_torch.core.backends.measure_seconds`), and the time
is apportioned over the plan's kernel calls and blended into the table.
``planner.save()`` persists the refined table.

Consumers: :mod:`repro_torch.serve.plan_cache` (the serving layer's
concurrent shape→plan cache) and :mod:`repro_torch.models.attention`
(decode P·V·Wo association, the ``decattn`` family).
"""

from __future__ import annotations

import dataclasses
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

from .algorithms import Algorithm, enumerate_algorithms
from .backends import get_backend, measure_seconds, register_torch_backends
from .discriminants import as_hybrid, get_discriminant
from .expr import Chain, bind_dims
from .perfmodel import AnalyticalHopperProfile, KernelProfile, TableProfile
from .profile_store import (
    current_fingerprint,
    load_default_profile,
    save_profile,
)
from .selector import select


@dataclasses.dataclass
class Plan:
    algorithm: Algorithm
    fn: Callable            # (*leaf tensors) -> result, on the backend
    ranked: Tuple[str, ...]  # algorithm names, best first (for logging)
    discriminant: str

    @property
    def flops(self) -> int:
        return self.algorithm.flops


def resolve_profile(
    profile: Optional[KernelProfile] = None,
    backend: str = "cuda",
    dtype: str = "float32",
    device="cuda",
) -> KernelProfile:
    """Tiered profile resolution: explicit → cached calibration → the
    Hopper model.

    A cached :class:`TableProfile` is wrapped into the hybrid policy so
    shapes the calibration never measured still get analytical estimates.
    """
    if profile is not None:
        return profile
    cached = load_default_profile(backend=backend, dtype=dtype,
                                  device=device)
    if cached is not None:
        return as_hybrid(cached)
    return AnalyticalHopperProfile()


class Planner:
    """Thread-safe, memoising planner with optional online refinement.

    ``backend`` is an execution-backend registry name (``cuda``: the
    hand-written kernels; ``torch``: plain ATen) and ``device`` where it
    runs (``cuda``, the default, raises without a card; ``cpu`` runs the
    plain versions). The profile is resolved under ``(profile_backend,
    profile_dtype)``: by default the ``cuda``/``float32`` calibration
    ``python -m repro_torch.core.calibrate`` writes, and, when recording,
    the runner's own tags — the same key :meth:`save` writes under.

    ``record=True``: every ``planner(chain, *tensors)`` execution is
    timed to completion, the seconds are apportioned over the plan's
    kernel calls by the *analytical* model's relative costs (see
    :meth:`observe`) and EMA-blended (``observation_blend``) into the
    live table. A pure analytical profile has no table, and ``observe``
    is then a no-op.

    Example (pure-arithmetic policy, on the CPU)::

        >>> from repro_torch.core.expr import matrix_chain
        >>> from repro_torch.core.planner import Planner
        >>> planner = Planner(discriminant="flops", device="cpu")
        >>> plan = planner.plan(matrix_chain(8, 512, 8, 512))
        >>> plan.algorithm.name
        'alg1[gemm+gemm]'
        >>> planner.plan(matrix_chain(8, 512, 8, 512)) is plan
        True
    """

    def __init__(
        self,
        discriminant: str = "perfmodel",
        profile: Optional[KernelProfile] = None,
        backend: Optional[str] = None,
        dtype_bytes: int = 4,
        record: bool = False,
        observation_blend: float = 0.25,
        profile_backend: Optional[str] = None,
        profile_dtype: Optional[str] = None,
        device="cuda",
    ):
        register_torch_backends()
        self.backend = backend or "cuda"
        self.device = device
        self.runner = get_backend(self.backend, device=device)
        run_tag, run_dtype = self.runner.fingerprint_tags()
        if profile_backend is None:
            profile_backend = run_tag if record else "cuda"
        if profile_dtype is None:
            profile_dtype = run_dtype if record else "float32"
        self.profile_backend = profile_backend
        self.profile_dtype = profile_dtype
        try:
            self._policy = get_discriminant(discriminant)
        except KeyError as e:
            raise ValueError(str(e)) from None
        self.discriminant = discriminant
        self.profile = resolve_profile(profile, backend=profile_backend,
                                       dtype=profile_dtype, device=device)
        self.dtype_bytes = dtype_bytes
        self.record = record
        self.observation_blend = observation_blend
        # One slot per (structure, dims, policy); the stored value carries
        # the profile generation it was ranked under, so refinement
        # invalidates it without growing the cache.
        self._cache: Dict[Tuple, Tuple[int, Plan]] = {}
        self._lock = threading.Lock()

    def _key(self, c: Chain, env) -> Tuple:
        dims = bind_dims(c, env or {})
        struct = tuple(
            (type(op).__name__, getattr(op, "symmetric", False))
            for op in c.ops
        )
        return (struct, dims, self._policy.fingerprint())

    def _profile_generation(self) -> int:
        """Mutation counter of the live table profile (−1: no table, or a
        policy that never reads the profile)."""
        if not self._policy.requires_profile:
            return -1
        table = self._recording_table()
        return table.generation if table is not None else -1

    def policy_fingerprint(self) -> Tuple:
        """Stable identity of the selection policy (registry key +
        params); :mod:`repro_torch.serve.plan_cache` folds it into its
        key."""
        return self._policy.fingerprint()

    def profile_generation(self) -> int:
        """The profile generation this planner would rank under; a bump
        means refinement may have flipped rankings (the serving cache's
        invalidation signal)."""
        return self._profile_generation()

    def plan(self, c: Chain, env: Optional[Dict[str, int]] = None) -> Plan:
        """Enumerate, rank, and memoise: chain + sizes → :class:`Plan`."""
        key = self._key(c, env)
        gen = self._profile_generation()
        with self._lock:
            hit = self._cache.get(key)
        if hit is not None and hit[0] == gen:
            return hit[1]
        algos = enumerate_algorithms(c, env)
        ranked = select(
            algos, self.discriminant,
            profile=self.profile if self._policy.requires_profile else None,
            dtype_bytes=self.dtype_bytes)
        best = ranked[0]
        plan = Plan(
            algorithm=best,
            fn=self.runner.build(best),
            ranked=tuple(a.name for a in ranked),
            discriminant=self.discriminant,
        )
        with self._lock:
            self._cache[key] = (gen, plan)
        return plan

    def __call__(self, c: Chain, *tensors, env=None):
        """Plan and evaluate in one call (tensors follow chain leaf order,
        each distinct matrix once). With ``record=True`` the execution is
        timed to completion and fed back into the live profile."""
        plan = self.plan(c, env)
        if not self.record:
            return plan.fn(*tensors)
        out, seconds = measure_seconds(plan.fn, *tensors)
        self.observe(plan, seconds)
        return out

    # -- online refinement ------------------------------------------------
    def _recording_table(self) -> Optional[TableProfile]:
        prof = self.profile
        if isinstance(prof, TableProfile):
            return prof
        return getattr(prof, "table_profile", None)

    def observe(self, plan: Plan, seconds: float) -> None:
        """Fold one measured plan execution back into the live profile.

        The time is apportioned over the plan's kernel calls in
        proportion to one model's predicted times — the hybrid profile's
        analytical member (measured and analytical entries mixed would
        credit the analytical ones with near-zero shares), or, for a plain
        table that lacks a kind, :class:`AnalyticalHopperProfile` — then
        EMA-blended into the table. No-op without a table.
        """
        table = self._recording_table()
        if table is None or seconds <= 0:
            return
        calls = plan.algorithm.calls
        if not calls:
            return
        weight_model = getattr(self.profile, "analytical", self.profile)
        try:
            preds = [max(weight_model.time(c, self.dtype_bytes), 1e-12)
                     for c in calls]
        except KeyError:
            weight_model = AnalyticalHopperProfile()
            preds = [max(weight_model.time(c, self.dtype_bytes), 1e-12)
                     for c in calls]
        total = sum(preds)
        blend = self.observation_blend
        with self._lock:
            for call, pred in zip(calls, preds):
                share = seconds * pred / total
                old = table.table.get((call.kind, call.dims))
                new = share if old is None else (
                    (1.0 - blend) * old + blend * share)
                table.record(call, new)

    def save(self, directory: Optional[Path] = None) -> Optional[Path]:
        """Persist the (possibly refined) table profile to the cache,
        under the planner's ``(profile_backend, profile_dtype)`` on its
        device — the key :func:`resolve_profile` loads with."""
        table = self._recording_table()
        if table is None:
            return None
        fp = current_fingerprint(backend=self.profile_backend,
                                 dtype=self.profile_dtype,
                                 device=self.device)
        return save_profile(table, fp, directory=directory,
                            meta={"source": "planner.online_refinement"})


_default_planner: Optional[Planner] = None
_planners_by_discriminant: Dict[str, "Planner"] = {}
_default_lock = threading.Lock()


def default_planner() -> Planner:
    """Process-wide planner on the card; loads the card's cached
    calibration at first use (see :func:`resolve_profile`)."""
    global _default_planner
    with _default_lock:
        if _default_planner is None:
            _default_planner = Planner()
        return _default_planner


def reset_default_planner() -> None:
    """Drop the cached process-wide planners (tests; post-calibration)."""
    global _default_planner
    with _default_lock:
        _default_planner = None
        _planners_by_discriminant.clear()


def plan(c: Chain, env: Optional[Dict[str, int]] = None,
         discriminant: str = "perfmodel") -> Plan:
    """Module-level convenience using a per-discriminant default planner."""
    p = default_planner()
    if discriminant != p.discriminant:
        with _default_lock:
            p = _planners_by_discriminant.get(discriminant)
            if p is None:
                p = Planner(discriminant=discriminant)
                _planners_by_discriminant[discriminant] = p
    return p.plan(c, env)
