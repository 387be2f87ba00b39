"""Planner-as-a-service: the concurrent shape→plan cache for serving.

The port's counterpart of the reference package's ``serve/plan_cache.py``.
The planner (:mod:`repro_torch.core.planner`) makes algorithm selection a
runtime feature; this module makes it a servable one. A decode path
cannot afford enumeration and ranking per request, nor a lock on the hit
path, so the work splits three ways:

* :class:`PlanCache` — shape→plan map with **lock-free reads**. A hit is
  one ``dict.get`` on an entry published fully constructed and never
  mutated. The single lock is taken only on a miss, to install an
  :class:`_Inflight` marker — which also **coalesces** requests: N
  concurrent same-shape misses run ONE enumeration; the other N−1 park
  on an event and read the published plan.
* **Generation invalidation** — the cache key is ``(expr, dims, dtype,
  backend, policy fingerprint, profile generation)``. Online refinement
  bumps the profile's generation; the next lookup misses, re-ranks under
  the new table, and publishing the fresh plan purges the stale
  same-shape entry, so the cache never grows per refinement.
* :class:`RefinementQueue` + a
  :class:`~repro_torch.runtime.supervisor.BackgroundWorker` — production
  timings are folded into the profile asynchronously. The request path
  appends to a bounded deque (drop-oldest, never blocks); the worker
  drains it through :meth:`Planner.observe`, and ``shutdown(drain=True)``
  quiesces producers, drains the worker, then re-drains inline.

:class:`PlanService` is the facade model code talks to; its plans run on
the ``cuda`` backend by default, so :meth:`PlanService.execute` launches
the hand-written kernels. The process-wide instance per device comes from
:func:`default_plan_service`; ``REPRO_SERVE_PLANNER=0`` is the
kill-switch.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.analysis import assert_algorithms_valid
from ..core.backends import measure_seconds
from ..core.expressions import get_spec
from ..core.planner import Plan, Planner
from ..runtime.supervisor import BackgroundWorker

__all__ = [
    "PlanCache", "PlanService", "RefinementQueue",
    "default_plan_service", "planner_enabled", "reset_default_plan_service",
]


def planner_enabled() -> bool:
    """Serving kill-switch: ``REPRO_SERVE_PLANNER=0`` disables the consult
    (model hot paths check it before touching the service)."""
    return os.environ.get("REPRO_SERVE_PLANNER", "1") != "0"


class _Inflight:
    """Per-key miss marker: the first thread computes, the rest wait."""

    __slots__ = ("event", "plan", "error")

    def __init__(self):
        self.event = threading.Event()
        self.plan: Optional[Plan] = None
        self.error: Optional[BaseException] = None


class _StatSlot:
    """One thread's counters; written without any lock (single writer)."""

    __slots__ = ("hits", "misses", "coalesced", "errors")

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.coalesced = 0
        self.errors = 0


class PlanCache:
    """Concurrent shape→plan cache: lock-free hits, coalesced misses.

    Keys are hashable tuples whose LAST component is the profile
    generation; the prefix identifies the shape. Publishing a plan for
    generation *g* purges any entry of the same prefix at another
    generation.

    Miss path: the lock guards only the in-flight map. The first thread
    per key installs an :class:`_Inflight` and runs ``compute()`` outside
    the lock; concurrent same-key callers wait on its event. A failed
    compute propagates to every waiter and uninstalls the marker, so the
    shape can be retried.

    Stats are exact and lock-free on the hot path: each thread owns a
    private :class:`_StatSlot` (registered once, under the lock).
    """

    def __init__(self):
        self._plans: Dict[Tuple, Plan] = {}
        self._by_prefix: Dict[Tuple, Tuple] = {}   # prefix -> live full key
        self._inflight: Dict[Tuple, _Inflight] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._slots: List[_StatSlot] = []

    # -- stats ------------------------------------------------------------
    def _slot(self) -> _StatSlot:
        slot = getattr(self._tls, "slot", None)
        if slot is None:
            slot = _StatSlot()
            self._tls.slot = slot
            with self._lock:
                self._slots.append(slot)
        return slot

    def stats(self) -> Dict[str, int]:
        """Aggregate counters across threads (cold path; exact totals)."""
        with self._lock:
            slots = list(self._slots)
            size = len(self._plans)
        out = {"hits": 0, "misses": 0, "coalesced": 0, "errors": 0}
        for s in slots:
            out["hits"] += s.hits
            out["misses"] += s.misses
            out["coalesced"] += s.coalesced
            out["errors"] += s.errors
        out["size"] = size
        out["lookups"] = out["hits"] + out["misses"] + out["coalesced"]
        return out

    # -- lookup -----------------------------------------------------------
    def get(self, key: Tuple, compute: Callable[[], Plan]) -> Plan:
        """Return the plan for ``key``, computing it at most once.

        ``key[:-1]`` is the shape prefix, ``key[-1]`` the profile
        generation. ``compute`` runs outside the lock in exactly one
        thread per in-flight key.
        """
        # The stat slot is acquired BEFORE any critical section: a
        # thread's first _slot() registers itself under self._lock, which
        # is not reentrant (the reference's first-lookup deadlock).
        slot = self._slot()
        plan = self._plans.get(key)          # lock-free hit path
        if plan is not None:
            slot.hits += 1
            return plan
        with self._lock:
            plan = self._plans.get(key)      # published while we raced
            if plan is not None:
                slot.hits += 1
                return plan
            inflight = self._inflight.get(key)
            if inflight is None:
                inflight = _Inflight()
                self._inflight[key] = inflight
                owner = True
            else:
                owner = False
        if not owner:
            slot.coalesced += 1
            inflight.event.wait()
            if inflight.error is not None:
                raise inflight.error
            return inflight.plan
        slot.misses += 1
        try:
            plan = compute()
        except BaseException as e:
            slot.errors += 1
            with self._lock:
                self._inflight.pop(key, None)
            inflight.error = e
            inflight.event.set()
            raise
        prefix = key[:-1]
        with self._lock:
            self._plans[key] = plan
            stale = self._by_prefix.get(prefix)
            if stale is not None and stale != key:
                self._plans.pop(stale, None)  # generation-bump purge
            self._by_prefix[prefix] = key
            self._inflight.pop(key, None)
        inflight.plan = plan
        inflight.event.set()
        return plan

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self._by_prefix.clear()


class RefinementQueue:
    """Bounded timing queue between the request path and the worker.

    ``put`` never blocks: at capacity the oldest pending timing is dropped
    (``dropped`` counts them), so backpressure costs refinement freshness,
    not request latency.
    """

    def __init__(self, maxlen: int = 1024):
        self._items: collections.deque = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.maxlen = maxlen
        self.enqueued = 0
        self.dropped = 0

    def put(self, item: Any) -> bool:
        """Append; returns False iff an older item was dropped to make room."""
        with self._lock:
            full = len(self._items) == self.maxlen
            self._items.append(item)       # deque(maxlen) evicts the head
            self.enqueued += 1
            if full:
                self.dropped += 1
            return not full

    def pop(self) -> Optional[Any]:
        with self._lock:
            return self._items.popleft() if self._items else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class PlanService:
    """Facade: zoo family + dims → plan, with async online refinement.

    Owns a :class:`~repro_torch.core.planner.Planner` (by default
    ``perfmodel`` on the ``cuda`` backend on ``device``), a
    :class:`PlanCache`, a :class:`RefinementQueue` and, with
    ``refine=True``, a :class:`~repro_torch.runtime.supervisor
    .BackgroundWorker` that drains timings into :meth:`Planner.observe`.

    ``lookup(family, dims)`` is the hot path: build the key, then a
    lock-free probe; a miss runs the planner under the coalescing
    protocol. ``execute(...)`` also runs the plan, times it to completion
    on the card, and enqueues the timing.
    """

    def __init__(self, discriminant: str = "perfmodel",
                 backend: str = "cuda", dtype: str = "float32",
                 planner: Optional[Planner] = None, refine: bool = False,
                 queue_maxlen: int = 1024, verify_plans: bool = True,
                 device="cuda"):
        self.planner = planner if planner is not None else Planner(
            discriminant=discriminant, backend=backend, device=device)
        self.dtype = dtype
        self.verify_plans = verify_plans
        self.cache = PlanCache()
        self.queue = RefinementQueue(maxlen=queue_maxlen)
        self.refine = refine
        self._accepting = True
        self.worker: Optional[BackgroundWorker] = None
        if refine:
            self.worker = BackgroundWorker(
                self._refine_step, name="plan-refine").start()

    # -- hot path ---------------------------------------------------------
    def key(self, family: str, dims: Sequence[int]) -> Tuple:
        """The serving cache key:
        ``(expr, dims, dtype, backend, policy fingerprint, generation)``.
        """
        return (family, tuple(int(d) for d in dims), self.dtype,
                self.planner.backend, self.planner.policy_fingerprint(),
                self.planner.profile_generation())

    def lookup(self, family: str, dims: Sequence[int]) -> Plan:
        """Shape → plan. Lock-free on a hit; coalesced planner call on a
        miss. With ``verify_plans`` the selected algorithm runs through
        the static verifier inside the coalesced compute, so the cache
        never serves or keeps a plan that fails analysis."""
        key = self.key(family, dims)

        def compute() -> Plan:
            spec = get_spec(family)
            chain = spec.chain(key[1])
            plan = self.planner.plan(chain)
            if self.verify_plans:
                assert_algorithms_valid(
                    [plan.algorithm], chain=chain,
                    context=f"serving plan {family}@{key[1]}")
            return plan

        return self.cache.get(key, compute)

    def execute(self, family: str, dims: Sequence[int], *tensors: Any) -> Any:
        """Plan, run, and (asynchronously) refine: the full request path.

        With ``refine`` the run is timed to its completion on the card
        (:func:`~repro_torch.core.backends.measure_seconds`) and the timing
        is queued for the worker, never folded on this thread.
        """
        plan = self.lookup(family, dims)
        if not self.refine:
            return plan.fn(*tensors)
        out, seconds = measure_seconds(plan.fn, *tensors)
        if self._accepting:
            self.queue.put((plan, seconds))
            if self.worker is not None:
                self.worker.notify()
        return out

    # -- refinement worker ------------------------------------------------
    def _refine_step(self) -> bool:
        item = self.queue.pop()
        if item is None:
            return False
        plan, seconds = item
        self.planner.observe(plan, seconds)
        return True

    # -- lifecycle --------------------------------------------------------
    def warmup(self, shapes: Sequence[Tuple[str, Sequence[int]]]) -> None:
        """Pre-plan known shapes so first requests hit the cache."""
        for family, dims in shapes:
            self.lookup(family, dims)

    def stats(self) -> Dict[str, Any]:
        out = dict(self.cache.stats())
        out["refine_enqueued"] = self.queue.enqueued
        out["refine_dropped"] = self.queue.dropped
        out["refine_pending"] = len(self.queue)
        if self.worker is not None:
            out["refine_steps"] = self.worker.steps
            out["refine_errors"] = self.worker.errors
        return out

    def shutdown(self, drain: bool = True, timeout: float = 10.0) -> bool:
        """Quiesce producers, then stop the worker (drain by default).

        With ``drain=True`` every timing enqueued by quiesced producers is
        folded before returning; a producer racing this call may enqueue
        after the worker saw an empty queue and exited, so the queue is
        re-drained inline once the worker is gone. Returns True iff the
        worker exited within ``timeout``.
        """
        self._accepting = False
        if self.worker is None:
            return True
        ok = self.worker.stop(drain=drain, timeout=timeout)
        if drain and ok:
            while self._refine_step():
                pass
        return ok


_default_services: Dict[str, PlanService] = {}
_default_lock = threading.Lock()


def _device_key(device) -> str:
    """``device`` with its index: ``cuda`` names the current card, so it
    and ``cuda:<current>`` share one service (a tensor's device always
    carries the index)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def default_plan_service(device="cuda") -> PlanService:
    """The process-wide service whose plans run on ``device`` (a lazy
    singleton per card: ``cuda:1`` gets its own, and ``cuda`` is the
    current card's): the one the model hot paths consult with their
    activations' device.

    Discriminant and backend come from ``REPRO_SERVE_DISCRIMINANT`` /
    ``REPRO_SERVE_BACKEND`` (defaults ``perfmodel`` / ``cuda``).
    """
    key = _device_key(device)
    svc = _default_services.get(key)
    if svc is not None:
        return svc
    with _default_lock:
        svc = _default_services.get(key)
        if svc is None:
            svc = PlanService(
                discriminant=os.environ.get(
                    "REPRO_SERVE_DISCRIMINANT", "perfmodel"),
                backend=os.environ.get("REPRO_SERVE_BACKEND", "cuda"),
                device=key)
            _default_services[key] = svc
        return svc


def reset_default_plan_service(shutdown: bool = True) -> None:
    """Drop the process-wide services (tests; config change)."""
    with _default_lock:
        services = list(_default_services.values())
        _default_services.clear()
    if shutdown:
        for svc in services:
            svc.shutdown(drain=False, timeout=2.0)
