"""Step-time watchdog.

Own copy of ``StragglerMonitor`` from the reference's
``runtime/supervisor.py``; the supervisor, heartbeat and background
workers there are not ported.
"""

from __future__ import annotations

from typing import List, Optional


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
