"""Operand arena and fast-path accounting for measured sweeps.

The PyTorch port's copy of the reference package's ``core/arena.py``
(framework-neutral, so the port keeps its own). Measured sweeps pay
per-point fixed costs that have nothing to do with the timed region:
operand allocation and RNG fill, algorithm enumeration, and the build of
what is timed (on a card, the capture of a CUDA graph). This module
provides the pieces the sweep fast path composes:

* :class:`OperandArena` — a shape-keyed buffer pool bound to one runner.
  Each distinct ``(base, rows, cols, symmetric, storage)`` leaf is
  synthesized once and reused across points and algorithms.
* :class:`PlacedArena` — the two-stage arena for a runner whose operands
  live on a device: :meth:`~PlacedArena.stage` synthesizes on the host
  (numpy only, so a helper thread may run it while the card is timed),
  :meth:`~PlacedArena.place` copies to the device on the thread that
  times, once per distinct buffer, so the same leaf keeps one device
  address across points.
* :func:`arena_for` — one arena per runner instance (weakly keyed, so a
  released runner releases its buffers).
* :func:`order_points_for_locality` — the measurement order that
  maximises arena/memo hits: stable lexicographic, i.e. exactly the
  row-major order grids are enumerated in.
* :func:`algorithm_structural_key` — a dims-free structural identity for
  an :class:`~repro_torch.core.algorithms.Algorithm`, part of the key of
  the ``cuda`` and ``torch`` backends' graph memo.
* :class:`FastPathStats` — the counter block surfaced by ``sweep()``
  results and the CLI's ``fastpath:`` line.

Duck-typed runners (the planted-mask oracles in
:mod:`repro_torch.core.synthetic`, deterministic test runners) work
unchanged: a runner without ``make_leaf_operand`` is probed through its
``make_operands(alg)`` once per distinct leaf shape.

Unlike the reference's copy, an arena holds its runner weakly: the
registry of arenas is weakly keyed by runner, and an arena holding its
runner strongly would keep every runner (and, on a card, its graphs)
alive for the life of the process.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .algorithms import Algorithm, Leaf

Point = Tuple[int, ...]

#: Sentinel stored for leaf keys the runner cannot synthesize (duck-typed
#: runners returning ``{}``) so they are probed once, not once per point.
_ABSENT = object()


# ------------------------------------------------------------------ stats ---


@dataclasses.dataclass
class FastPathStats:
    """Counters for one fast-path run (mergeable across shards/rounds).

    ``overlap_s`` is the portion of preparation work (enumeration +
    operand synthesis) that executed concurrently with a GIL-releasing
    timed region instead of serially before it; ``prep_s`` is the total
    preparation time, so ``overlap_fraction`` is the share of fixed cost
    the pipeline actually hid.
    """

    arena_hits: int = 0
    arena_misses: int = 0
    arena_bytes: int = 0
    memo_hits: int = 0
    memo_misses: int = 0
    points_pipelined: int = 0
    prep_s: float = 0.0
    overlap_s: float = 0.0

    @property
    def overlap_fraction(self) -> float:
        return self.overlap_s / self.prep_s if self.prep_s > 0 else 0.0

    def merge(self, other: "FastPathStats") -> "FastPathStats":
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
        return self

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, float]) -> "FastPathStats":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def add_arena_delta(self, before: Tuple[int, int, int],
                        after: Tuple[int, int, int]) -> None:
        self.arena_hits += after[0] - before[0]
        self.arena_misses += after[1] - before[1]
        self.arena_bytes += after[2] - before[2]

    def add_memo_delta(self, before: Tuple[int, int],
                       after: Tuple[int, int]) -> None:
        self.memo_hits += after[0] - before[0]
        self.memo_misses += after[1] - before[1]

    def summary(self) -> str:
        mb = self.arena_bytes / 1e6
        return (f"arena {self.arena_hits}h/{self.arena_misses}m "
                f"({mb:.1f} MB), memo {self.memo_hits}h/{self.memo_misses}m, "
                f"pipelined {self.points_pipelined} "
                f"(overlap {self.overlap_fraction:.0%})")


def memo_counts(runner: object) -> Tuple[int, int]:
    """(hits, misses) of the runner's executable memo; zeros if it has
    none (CPU backends, duck-typed runners)."""
    return (int(getattr(runner, "memo_hits", 0)),
            int(getattr(runner, "memo_misses", 0)))


# ------------------------------------------------------------------ arena ---


def _leaf_key(ref: Leaf) -> Tuple:
    """Shape-keyed identity of a leaf's *backing buffer* (untransposed:
    a transposed view and the plain operand share one array)."""
    r, c = (ref.cols, ref.rows) if ref.transposed else (ref.rows, ref.cols)
    return (ref.base, r, c, ref.symmetric, ref.storage)


def _iter_leaves(alg: Algorithm) -> Iterable[Leaf]:
    for step in getattr(alg, "steps", ()):
        for ref in (step.lhs, step.rhs):
            if isinstance(ref, Leaf):
                yield ref


class OperandArena:
    """Shape-keyed operand buffers, bound to one runner.

    ``operands(algos)`` returns a ``{base: buffer}`` dict covering every
    leaf of every algorithm — the union the legacy path built through
    per-algorithm ``make_operands`` + ``setdefault`` merging — but each
    distinct leaf shape is synthesized at most once for the arena's
    lifetime. Buffers are handed to timed kernels read-only by
    convention (no kernel of the port writes its inputs); what happens
    around each timed repetition stays inside the backend's per-rep hook,
    not at allocation time.
    """

    def __init__(self, runner: object) -> None:
        self._runner = weakref.ref(runner)
        self._buffers: Dict[Tuple, object] = {}
        self.hits = 0
        self.misses = 0
        self.nbytes = 0

    def __len__(self) -> int:
        return sum(1 for v in self._buffers.values() if v is not _ABSENT)

    def snapshot(self) -> Tuple[int, int, int]:
        return (self.hits, self.misses, self.nbytes)

    def clear(self) -> None:
        self._buffers.clear()

    def _store(self, key: Tuple, buf: object) -> None:
        self._buffers[key] = buf
        if buf is not _ABSENT:
            self.misses += 1
            self.nbytes += int(getattr(buf, "nbytes", 0))

    @property
    def runner(self) -> object:
        runner = self._runner()
        if runner is None:
            raise ReferenceError("the arena's runner was released")
        return runner

    def _synthesize(self, ref: Leaf, alg: Algorithm) -> None:
        """Fill the cache entry for ``ref`` (and, via the legacy
        whole-algorithm fallback, any sibling leaves that come for free)."""
        make_leaf = getattr(self.runner, "make_leaf_operand", None)
        if make_leaf is not None:
            self._store(_leaf_key(ref), make_leaf(ref))
            return
        # Duck-typed runner: probe through the legacy whole-algorithm
        # entry point and harvest whatever it produced.
        produced = self.runner.make_operands(alg)
        for leaf in _iter_leaves(alg):
            key = _leaf_key(leaf)
            if key not in self._buffers:
                buf = produced.get(leaf.base, _ABSENT)
                self._store(key, buf)
        if _leaf_key(ref) not in self._buffers:  # alg had no matching leaf
            self._store(_leaf_key(ref), produced.get(ref.base, _ABSENT))

    def operands(self, algos: Sequence[Algorithm]) -> Dict[int, object]:
        """Union operand dict for ``algos``, served from the pool."""
        out: Dict[int, object] = {}
        for alg in algos:
            for ref in _iter_leaves(alg):
                if ref.base in out:
                    continue
                key = _leaf_key(ref)
                buf = self._buffers.get(key)
                if buf is None:
                    self._synthesize(ref, alg)
                    buf = self._buffers[key]
                else:
                    self.hits += 1
                if buf is not _ABSENT:
                    out[ref.base] = buf
        return out

    def stage(self, algos: Sequence[Algorithm]) -> Dict[int, object]:
        """The first of two stages (see :class:`PlacedArena`): here the
        whole of :meth:`operands`."""
        return self.operands(algos)

    def place(self, staged: Dict[int, object]) -> Dict[int, object]:
        """The second stage: nothing left to do."""
        return staged


class _HostLeaves:
    """A runner's host synthesis, seen as a runner: ``make_leaf_operand``
    returns the leaf as float32 numpy, rounded exactly as the runner's
    ``_asarray`` rounds it."""

    def __init__(self, runner: object) -> None:
        self._runner = weakref.ref(runner)

    def make_leaf_operand(self, ref: Leaf) -> object:
        return self._runner().synthesize_leaf(ref).astype(np.float32)


class PlacedArena:
    """Two-stage arena for a runner whose operands live on a device.

    :meth:`stage` serves host buffers from an :class:`OperandArena` over
    the runner's host synthesis (numpy only, no device call: safe on a
    helper thread while the card runs a timed repetition, and while the
    timing thread captures a CUDA graph); :meth:`place` copies each host
    buffer to the device once, on the calling thread, and serves the same
    device buffer afterwards. The union dict and the hit/miss counts are
    the single-stage arena's; the device buffers hold what the runner's
    ``make_leaf_operand`` would place, bit for bit.
    """

    def __init__(self, runner: object) -> None:
        self._runner = weakref.ref(runner)
        self._leaves = _HostLeaves(runner)   # the host arena holds it weakly
        self.host = OperandArena(self._leaves)
        self._placed: Dict[int, object] = {}

    def __len__(self) -> int:
        return len(self.host)

    def snapshot(self) -> Tuple[int, int, int]:
        return self.host.snapshot()

    def clear(self) -> None:
        self.host.clear()
        self._placed.clear()

    def stage(self, algos: Sequence[Algorithm]) -> Dict[int, object]:
        return self.host.operands(algos)

    def place(self, staged: Dict[int, object]) -> Dict[int, object]:
        out: Dict[int, object] = {}
        for base, host in staged.items():
            # The host arena keeps every buffer it served, so id() is stable.
            buf = self._placed.get(id(host))
            if buf is None:
                buf = self._runner()._asarray(host)
                self._placed[id(host)] = buf
            out[base] = buf
        return out

    def operands(self, algos: Sequence[Algorithm]) -> Dict[int, object]:
        return self.place(self.stage(algos))


_ARENAS: "weakref.WeakKeyDictionary[object, object]" = (
    weakref.WeakKeyDictionary())


def arena_for(runner: object):
    """The arena bound to ``runner`` (created on first use): a
    :class:`PlacedArena` for a runner that synthesizes on the host and
    places (the port's backends: ``synthesize_leaf`` and ``_asarray``), an
    :class:`OperandArena` for any other.

    Weakly keyed: a process-pool worker's cached runner keeps one arena
    across chunks; dropping the runner drops its buffers. Runners that
    cannot be weakly referenced or hashed get a fresh (unpooled) arena —
    correct, just without cross-call reuse.
    """
    two_stage = hasattr(runner, "synthesize_leaf") and hasattr(
        runner, "_asarray")
    try:
        arena = _ARENAS.get(runner)
    except TypeError:
        return OperandArena(runner)
    if arena is None:
        arena = PlacedArena(runner) if two_stage else OperandArena(runner)
        try:
            _ARENAS[runner] = arena
        except TypeError:
            pass
    return arena


# ------------------------------------------------------------- scheduling ---


def order_points_for_locality(points: Iterable[Point]) -> List[Point]:
    """Measurement order maximising arena/memo reuse between neighbours.

    Stable lexicographic sort: identical to row-major grid enumeration
    (so a dense sweep's measurement order — and therefore its atlas byte
    stream — is unchanged), and arbitrary admitted sets (adaptive
    refinement rounds, shard slices) get consecutive points sharing
    leading dimensions, i.e. sharing operand shapes.
    """
    return sorted(points)


# -------------------------------------------------------- structural keys ---


def algorithm_structural_key(alg: Algorithm) -> Tuple:
    """Dims-free structural identity of an algorithm's step DAG.

    Captures everything the backend step-walker dispatches on — kernel
    kind, SYMM side, operand refs (leaf base/index/transposed/symmetric/
    storage, renumbered intermediate ids), output storage — and nothing
    shape-dependent. Two algorithms with the same key walk the same
    kernels in the same order; a captured CUDA graph bakes in shapes and
    addresses too, so the backends' graph memo keys on this plus the
    dims and the inputs (:meth:`TorchBackend._timed_callable`).
    """
    renum = {s.out: i for i, s in enumerate(alg.steps)}

    def ref_key(r: object) -> Optional[Tuple]:
        if r is None:
            return None
        if isinstance(r, Leaf):
            return ("l", r.index, r.base, r.transposed, r.symmetric,
                    r.storage)
        i = renum.get(r)  # type: ignore[arg-type]
        # Provenance-only ids (e.g. a pruned SYRK twin) are never fetched
        # by the walker; collapse them so they don't split the memo.
        return ("s", i) if i is not None else ("dead",)

    return tuple(
        (s.call.kind, s.symm_side, ref_key(s.lhs), ref_key(s.rhs),
         s.out_storage, s.out_symmetric)
        for s in alg.steps)
