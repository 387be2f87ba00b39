"""Run supervision: bounded restarts, stragglers, heartbeats, background
workers.

The port's copy of the reference's ``runtime/supervisor.py``:

  * :class:`Supervisor` — ``run(fn)`` with bounded restarts and
    exponential backoff (:class:`RestartPolicy`); the train loop restores
    from its latest checkpoint on each attempt, so a restart loses at most
    the steps since the last save.
  * :class:`BackgroundWorker` — drainable daemon loop around a ``step()``
    callable: the serving plan cache's refinement worker
    (:mod:`repro_torch.serve.plan_cache`).
  * :class:`StragglerMonitor` — EMA of step wall time; decode-step latency
    and the train loop's step times feed one.
  * :class:`Heartbeat` — a thread that records liveness timestamps, so a
    test can assert the failure-detection contract (N missed beats →
    declared dead).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, List, Optional


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    backoff_s: float = 1.0
    backoff_mult: float = 2.0
    max_backoff_s: float = 60.0


class Supervisor:
    def __init__(self, policy: Optional[RestartPolicy] = None,
                 sleep=time.sleep):
        self.policy = policy or RestartPolicy()
        self.restarts = 0
        self.failures: List[BaseException] = []
        self._sleep = sleep

    def run(self, fn: Callable[[int], Any]) -> Any:
        """Run ``fn(attempt)`` until success or restart budget exhausted.

        ``fn`` is expected to restore from the latest checkpoint itself
        (the train loop does), so supervisor restarts lose at most the
        steps since the last save.
        """
        backoff = self.policy.backoff_s
        attempt = 0
        while True:
            try:
                return fn(attempt)
            except KeyboardInterrupt:
                raise
            except BaseException as e:
                self.failures.append(e)
                self.restarts += 1
                if self.restarts > self.policy.max_restarts:
                    raise RuntimeError(
                        f"restart budget exhausted after "
                        f"{self.policy.max_restarts} restarts"
                    ) from e
                self._sleep(backoff)
                backoff = min(backoff * self.policy.backoff_mult,
                              self.policy.max_backoff_s)
                attempt += 1


class BackgroundWorker:
    """Drainable daemon loop around a ``step()`` callable.

    ``step()`` performs one unit of work and returns truthy, or returns
    falsy when its work source is empty — the worker then parks on an
    event until :meth:`notify` (producers call it after enqueueing) or
    the idle poll interval elapses.

    Shutdown contract (what the plan cache's refinement worker needs):

    * ``stop(drain=True)`` — graceful: the loop keeps calling ``step()``
      until it reports idle, then exits; ``stop`` joins the thread. With
      producers quiesced first, this is a *deterministic* drain — every
      item enqueued before the call is processed before ``stop`` returns.
    * ``stop(drain=False)`` — prompt: the loop exits before the next
      ``step()``; unprocessed items stay in the owner's queue.

    Exceptions from ``step()`` are counted (``errors``), reported to
    ``on_error`` and treated as one unit of work — a poisoned item must
    not wedge the drain. The worker never re-raises into the owner.
    """

    def __init__(self, step: Callable[[], Any], name: str = "bg-worker",
                 idle_wait_s: float = 0.05,
                 on_error: Optional[Callable[[BaseException], Any]] = None):
        self._step = step
        self._name = name
        self._idle_wait = idle_wait_s
        self._on_error = on_error
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._drain = True
        self._thread: Optional[threading.Thread] = None
        self.steps = 0
        self.errors = 0

    def start(self) -> "BackgroundWorker":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop_evt.clear()
        self._wake.clear()
        self._thread = threading.Thread(target=self._run, name=self._name,
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            if self._stop_evt.is_set() and not self._drain:
                return
            try:
                did = bool(self._step())
            except Exception as e:  # noqa: BLE001 — isolate the owner
                self.errors += 1
                did = True
                if self._on_error is not None:
                    self._on_error(e)
            if did:
                self.steps += 1
                continue
            if self._stop_evt.is_set():
                return  # stopping + idle == drained
            self._wake.wait(self._idle_wait)
            self._wake.clear()

    def notify(self) -> None:
        """Wake the worker (a producer enqueued work)."""
        self._wake.set()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self, drain: bool = True, timeout: float = 10.0) -> bool:
        """Stop the loop; returns True iff the thread exited in time."""
        self._drain = bool(drain)
        self._stop_evt.set()
        self._wake.set()
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        if t.is_alive():
            return False
        self._thread = None
        return True


class StragglerMonitor:
    """EMA step-time watchdog."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0,
                 warmup_steps: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup_steps
        self.ema: Optional[float] = None
        self.n = 0
        self.flagged: List[int] = []

    def observe(self, step: int, wall_s: float) -> bool:
        """Record one step; returns True if flagged as straggler."""
        self.n += 1
        if self.ema is None:
            self.ema = wall_s
            return False
        is_slow = (self.n > self.warmup
                   and wall_s > self.threshold * self.ema)
        if is_slow:
            self.flagged.append(step)
        else:
            # stragglers don't poison the EMA
            self.ema = (1 - self.alpha) * self.ema + self.alpha * wall_s
        return is_slow


class Heartbeat:
    """Liveness publisher + failure detector (local, test-oriented)."""

    def __init__(self, interval_s: float = 1.0, miss_limit: int = 3):
        self.interval = interval_s
        self.miss_limit = miss_limit
        self.last_beat: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        def run():
            while not self._stop.is_set():
                self.last_beat = time.monotonic()
                self._stop.wait(self.interval)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    def is_alive(self, now: Optional[float] = None) -> bool:
        if self.last_beat is None:
            return False
        now = now if now is not None else time.monotonic()
        return (now - self.last_beat) < self.interval * self.miss_limit
