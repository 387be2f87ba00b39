"""The device trace of a ``--trace 1`` run, reduced to what the per-layer
readers need.

The traffic module opens a window (:meth:`Tracer.start`), drops marks at
the harness's own span boundaries (:meth:`Tracer.mark`, a zero-length
``record_function`` range named ``bench:<span>``) and closes it
(:meth:`Tracer.stop`). The reduction keeps every device interval (kernel,
memcpy, memset) of the window as arrays, so a reader can ask for the
device time between two marks, the device's busy time (the union of the
intervals), the kernels that took the most time, and the idle gaps.

It also keeps the program's own host ranges (``repro:<name>``, which
``repro_torch.runtime.spans`` opens under the profiler), so that an idle
gap is named by the innermost program range open on the host when the
device started again; where none is open, by the latest boundary before
that moment, a harness mark or the start of a program range (a CUDA
graph's replay opens only an empty range at its start).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

NAME_CHARS = 100      # kernel names are cut to this many characters
HARNESS, PROGRAM = "bench:", "repro:"


class TraceSummary:
    def __init__(self, intervals: List[Tuple[int, int, str]],
                 marks: List[Tuple[int, str]],
                 ranges: Sequence[Tuple[int, int, str]] = ()):
        self.marks = sorted(marks)
        if len(self.marks) < 2:
            raise ValueError("a traced window needs a start and an end mark")
        self.t0, self.t1 = self.marks[0][0], self.marks[-1][0]
        self.ranges = sorted(ranges)
        ivs = sorted((s, e, n) for s, e, n in intervals
                     if e > self.t0 and s < self.t1)
        self.starts = [max(s, self.t0) for s, _, _ in ivs]
        self.ends = [min(e, self.t1) for _, e, _ in ivs]
        self.names = [n for _, _, n in ivs]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def device_s(self, t0: Optional[int] = None, t1: Optional[int] = None,
                 contains: Optional[str] = None) -> float:
        """Summed device time of the intervals that start in [t0, t1)
        (the whole window by default), those whose name holds
        ``contains`` only."""
        t0 = self.t0 if t0 is None else t0
        t1 = self.t1 if t1 is None else t1
        lo, hi = bisect.bisect_left(self.starts, t0), \
            bisect.bisect_left(self.starts, t1)
        return sum(self.ends[i] - self.starts[i] for i in range(lo, hi)
                   if contains is None or contains in self.names[i]) / 1e9

    def busy_spans(self) -> List[Tuple[int, int]]:
        """The union of the device intervals, in order."""
        merged: List[List[int]] = []
        for s, e in zip(self.starts, self.ends):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_spans()) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, int] = defaultdict(int)
        for s, e, name in zip(self.starts, self.ends, self.names):
            by[name[:NAME_CHARS]] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest stretches of the window with no device
        interval, each named by :meth:`host_at` the moment the device
        started again."""
        gaps, edge = [], self.t0
        for s, e in self.busy_spans() + [(self.t1, self.t1)]:
            if s > edge:
                gaps.append((s - edge, s))
            edge = max(edge, e)
        return [[self.host_at(end), length / 1e9]
                for length, end in sorted(gaps, reverse=True)[:n]]

    def host_at(self, t: int) -> str:
        """What the host was doing at ``t``: the innermost program range
        open then (the latest to start of those that hold ``t``), else the
        latest harness mark or program range start before ``t``."""
        inner = None
        for start, end, name in self.ranges:
            if start > t:
                break
            if end > t:
                inner = name
        if inner is not None:
            return inner
        bounds = self.marks + [(s, name) for s, _, name in self.ranges]
        before = [b for b in bounds if b[0] < t]
        return max(before)[1] if before else self.marks[0][1]

    def mark_times(self, name: str) -> List[int]:
        return [t for t, m in self.marks if m == name]


def _is_device(event) -> bool:
    return str(event.device_type()).endswith("CUDA") and \
        not event.is_user_annotation()


def summarize(prof) -> TraceSummary:
    """Reduce a stopped ``torch.profiler.profile`` to a summary: the
    device intervals, the harness's marks and the program's host
    ranges."""
    intervals, marks, ranges = [], [], []
    for ev in prof.profiler.kineto_results.events():
        name, start = ev.name(), ev.start_ns()
        on_host = not str(ev.device_type()).endswith("CUDA")
        if name.startswith(HARNESS):
            if on_host:
                marks.append((start, name[len(HARNESS):]))
        elif name.startswith(PROGRAM):
            if on_host:
                ranges.append((start, start + ev.duration_ns(),
                               name[len(PROGRAM):]))
        elif _is_device(ev):
            intervals.append((start, start + ev.duration_ns(), name))
    return TraceSummary(intervals, marks, ranges)


class Tracer:
    """A ``torch.profiler`` window, or nothing when tracing is off."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.summary: Optional[TraceSummary] = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def start(self, span: str) -> None:
        if not self.enabled or self.prof is not None or \
                self.summary is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.mark(span)

    def mark(self, span: str) -> None:
        if self.prof is None:
            return
        from torch.profiler import record_function
        with record_function(HARNESS + span):
            pass

    def stop(self, span: str = "end") -> None:
        if self.prof is None:
            return
        self.mark(span)
        self.prof.stop()
        self.summary = summarize(self.prof)
        self.prof = None
