"""Step-time watchdog and drainable background workers.

Own copies of ``StragglerMonitor`` and ``BackgroundWorker`` from the
reference's ``runtime/supervisor.py``: decode-step latency feeds a
:class:`StragglerMonitor`, and the serving plan cache's refinement worker
(:mod:`repro_torch.serve.plan_cache`) is a :class:`BackgroundWorker`. The
supervisor's restart loop and heartbeat are not ported (ROADMAP A8).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional


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
