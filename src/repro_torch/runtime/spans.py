"""Spans and counters inside the port: which code owns a step's time.

A :class:`Recorder` keeps, in memory, every span and counter that the
program reports while it is active (``with recorder: ...``), and hands
them out on request (:meth:`Recorder.export`, :meth:`Recorder.summary`);
nothing is written to disk. A span has a name, its parent, the step it
belongs to (:func:`begin_step`, called by the train loop), a start and an
end. Counters (:func:`count`) are taken at the same boundaries.

Two clocks:

* **host** — :func:`span` keeps the host's ``perf_counter_ns`` at its
  boundaries, and under ``torch.profiler`` it also opens a
  ``record_function("repro:<name>")`` range, so that the span lies on the
  profiler's own clock (around the block, or, for a block that launches a
  CUDA graph, an empty one at its start);
* **device** — with a recorder active, a boundary of :func:`span` (unless
  ``device=False``) or of :func:`region` also drops a mark on the current
  stream: a ``torch.cuda.Event(enable_timing=True, external=True)``. A
  mark recorded while a CUDA graph captures becomes an event-record node
  of the graph (:func:`capturing` keeps those marks apart), and every
  replay records it again (:func:`replayed`), so after the step's sync
  :meth:`Recorder.collect` reads that step's device spans with no
  profiler. On the CPU a mark is the host clock.

Autograd's passes have no Python frame around them: :func:`region` and
:func:`region_end` put identity ``autograd.Function`` nodes on a region's
inputs and outputs, whose forward marks the region and whose backward
marks ``<name>.bwd``, opened when the outputs' gradient arrives and closed
when every input's gradient has been produced.

With no recorder active and no profiler running, :func:`span` is one
check, :func:`region` returns its arguments as they are, and a captured
graph holds no mark: the program runs as if this module were absent.
"""

from __future__ import annotations

import contextlib
import statistics
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

#: Prefix of the ``record_function`` range of every host span.
PREFIX = "repro:"
#: Suffix of a region's backward span.
BWD = ".bwd"


class Span(NamedTuple):
    id: int
    name: str
    parent: Optional[int]   # id of the enclosing span of the same clock
    step: Optional[int]
    start_ms: float         # host: since the recorder was made; device:
    end_ms: float           # since the step's first mark
    clock: str              # "host" | "device"


class _Mark:
    """A device span until :meth:`Recorder.collect` reads it."""

    __slots__ = ("name", "parent", "start", "end")

    def __init__(self, name: str, parent: Optional["_Mark"], start):
        self.name, self.parent, self.start, self.end = name, parent, start, None


_ACTIVE: Optional["Recorder"] = None


class Recorder:
    """What the program reports while this recorder is active. Device
    marks are CUDA events on ``device`` (the card when there is one) or,
    on the CPU, the host clock."""

    def __init__(self, device=None):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = defaultdict(int)
        self.step: Optional[int] = None
        self._t0 = time.perf_counter_ns()
        self._ids = 0
        self._host: List[Tuple[int, str, Optional[int], Optional[int],
                               int]] = []
        self._open: List[_Mark] = []
        self._by_name: Dict[str, List[_Mark]] = defaultdict(list)
        self._pending: List[_Mark] = []
        self._lock = threading.Lock()
        self._previous: Optional[Recorder] = None

    def __enter__(self) -> "Recorder":
        global _ACTIVE
        self._previous, _ACTIVE = _ACTIVE, self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE, self._previous = self._previous, None

    def _id(self) -> int:
        self._ids += 1
        return self._ids

    # ------------------------------------------------------------ host --

    def _host_ms(self, ns: int) -> float:
        return (ns - self._t0) / 1e6

    def open_host(self, name: str) -> None:
        parent = self._host[-1][0] if self._host else None
        self._host.append((self._id(), name, parent, self.step,
                           time.perf_counter_ns()))

    def close_host(self) -> None:
        end = time.perf_counter_ns()
        sid, name, parent, step, start = self._host.pop()
        self.spans.append(Span(sid, name, parent, step, self._host_ms(start),
                               self._host_ms(end), "host"))

    # ---------------------------------------------------------- device --

    def _mark(self):
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True, external=True)
            event.record()
            return event
        return time.perf_counter_ns()

    def open_device(self, name: str) -> None:
        with self._lock:
            mark = _Mark(name, self._open[-1] if self._open else None,
                         self._mark())
            self._open.append(mark)
            self._by_name[name].append(mark)
            self._pending.append(mark)

    def close_device(self, name: str) -> None:
        """Close the latest open device span named ``name``."""
        with self._lock:
            opened = self._by_name.get(name)
            if not opened:
                return
            mark = opened.pop()
            mark.end = self._mark()
            self._open.remove(mark)

    @contextlib.contextmanager
    def capturing(self) -> Iterator[List[_Mark]]:
        """Keep the device marks of the block (a CUDA graph's capture)
        apart from the step's: the list it yields receives them, to be
        handed to :meth:`replayed` after each replay."""
        outer, self._pending = self._pending, []
        try:
            yield self._pending
        finally:
            self._pending = outer

    def replayed(self, marks: List[_Mark]) -> None:
        """A replay of the graph whose capture recorded ``marks`` ran in
        this step."""
        self._pending.extend(marks)

    def begin_step(self, step: int) -> None:
        """Host spans from here on belong to ``step``; device marks of the
        step before that :meth:`collect` has not read are dropped."""
        self.step = step
        self._pending = []

    def collect(self) -> List[Span]:
        """Read the device spans of the current step (after its sync; this
        synchronises the device), keep them and return them. Their times
        are milliseconds from the step's first mark; a span left open is
        dropped."""
        marks = [m for m in self._pending if m.end is not None]
        self._pending = []
        if not marks:
            return []
        base = marks[0].start
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

            def offset(mark):
                return 0.0 if mark is base else base.elapsed_time(mark)
        else:
            def offset(mark):
                return (mark - base) / 1e6
        ids = {id(m): self._id() for m in marks}
        out = [Span(ids[id(m)], m.name,
                    ids.get(id(m.parent)) if m.parent is not None else None,
                    self.step, offset(m.start), offset(m.end), "device")
               for m in marks]
        self.spans.extend(out)
        return out

    # --------------------------------------------------------- reading --

    def self_ms(self, clock: str = "device") -> Dict[int, float]:
        """Each span's self time by id: its duration less the part of it
        that its children cover."""
        kids: Dict[int, List[Span]] = defaultdict(list)
        spans = [s for s in self.spans if s.clock == clock]
        for s in spans:
            if s.parent is not None:
                kids[s.parent].append(s)
        out = {}
        for s in spans:
            covered, edge = 0.0, s.start_ms
            for k in sorted(kids[s.id], key=lambda k: k.start_ms):
                lo, hi = max(k.start_ms, edge), min(k.end_ms, s.end_ms)
                if hi > lo:
                    covered += hi - lo
                    edge = hi
            out[s.id] = s.end_ms - s.start_ms - covered
        return out

    def per_step(self, clock: str = "device"
                 ) -> Dict[Optional[int], Dict[str, Tuple[float, float]]]:
        """{step: {name: (total ms, self ms)}}, each summed over the
        name's spans in the step."""
        own = self.self_ms(clock)
        out: Dict[Optional[int], Dict[str, List[float]]] = defaultdict(dict)
        for s in self.spans:
            if s.clock != clock:
                continue
            total, self_ = out[s.step].get(s.name, (0.0, 0.0))
            out[s.step][s.name] = (total + s.end_ms - s.start_ms,
                                   self_ + own[s.id])
        return dict(out)

    def summary(self, clock: str = "device", steps=None
                ) -> Dict[str, Dict[str, float]]:
        """{name: {"total_ms", "self_ms", "steps"}}: the medians a step of
        the name's summed times, over the steps (all, or those of
        ``steps``) in which it appears."""
        by: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        for step, names in self.per_step(clock).items():
            if steps is not None and step not in steps:
                continue
            for name, times in names.items():
                by[name].append(times)
        return {name: {"total_ms": statistics.median(t for t, _ in v),
                       "self_ms": statistics.median(s for _, s in v),
                       "steps": len(v)}
                for name, v in sorted(by.items())}

    def export(self) -> dict:
        """Every span kept and every counter, as plain data."""
        return {"spans": [s._asdict() for s in self.spans],
                "counts": dict(self.counts)}


# ------------------------------------------- what the program calls ---

def active() -> Optional[Recorder]:
    return _ACTIVE


@contextlib.contextmanager
def _span(rec: Optional[Recorder], name: str, device: bool, enclose: bool):
    profiling = _profiler._is_profiler_enabled
    if profiling and not enclose:
        with torch.profiler.record_function(PREFIX + name):
            pass
    with torch.profiler.record_function(PREFIX + name) \
            if profiling and enclose else contextlib.nullcontext():
        if rec is None:
            yield
            return
        rec.open_host(name)
        if device:
            rec.open_device(name)
        try:
            yield
        finally:
            if device:
                rec.close_device(name)
            rec.close_host()


def span(name: str, device: bool = True, enclose: bool = True):
    """A host span ``name`` (and, with ``device``, a device span) around
    the block; nothing with no recorder active and no profiler running.
    Under the profiler the block is a ``repro:<name>`` range, or, without
    ``enclose``, the range is empty and marks the block's start: a range
    open around the launch of a CUDA graph of ~20,000 kernels holds the
    launch ~7 ms longer under the profiler."""
    rec = _ACTIVE
    if rec is None and not _profiler._is_profiler_enabled:
        return contextlib.nullcontext()
    return _span(rec, name, device, enclose)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rec, name, *tensors):
        ctx.rec, ctx.name = rec, name
        ctx.set_materialize_grads(False)
        rec.open_device(name)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        ctx.rec.close_device(ctx.name + BWD)
        return (None, None) + grads


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rec, name, *tensors):
        ctx.rec, ctx.name = rec, name
        ctx.set_materialize_grads(False)
        rec.close_device(name)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        ctx.rec.open_device(ctx.name + BWD)
        return (None, None) + grads


def _through(fn, name: str, args):
    rec = _ACTIVE
    if rec is None:
        return args[0] if len(args) == 1 else args
    out = list(args)
    where = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    for i, t in zip(where, fn.apply(rec, name, *(args[i] for i in where))):
        out[i] = t
    return out[0] if len(out) == 1 else tuple(out)


def region(name: str, *tensors):
    """Open device region ``name`` on its inputs ``tensors`` (``None``
    passes through); returns them (one, or a tuple), as views through an
    identity node while a recorder is active, the very same objects
    otherwise. Close it with :func:`region_end` on its outputs."""
    return _through(_Enter, name, tensors)


def region_end(name: str, *tensors):
    """Close the latest open region ``name`` on its outputs ``tensors``;
    returns them as :func:`region` does."""
    return _through(_Exit, name, tensors)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the active recorder."""
    if _ACTIVE is not None:
        _ACTIVE.counts[name] += n


def begin_step(step: int) -> None:
    if _ACTIVE is not None:
        _ACTIVE.begin_step(step)


@contextlib.contextmanager
def capturing() -> Iterator[List[_Mark]]:
    """:meth:`Recorder.capturing` of the active recorder; an empty list
    with none."""
    if _ACTIVE is None:
        yield []
        return
    with _ACTIVE.capturing() as marks:
        yield marks


def replayed(marks: List[_Mark]) -> None:
    if _ACTIVE is not None and marks:
        _ACTIVE.replayed(marks)
