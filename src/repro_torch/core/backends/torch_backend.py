"""The ``torch`` and ``cuda`` execution backends.

Counterpart of the reference package's ``core/backends/jax_backend.py``:

* ``torch`` (:class:`TorchBackend`) lowers every kernel kind to plain
  ATen calls — the counterpart of ``jax``;
* ``cuda`` (:class:`CudaBackend`) routes gemm/syrk/symm and the fused
  ``gemm+gemm`` and ``gemm+syrk`` pairs through the hand-written kernels
  of :mod:`repro_torch.kernels.ops` — the counterpart of ``pallas``.

``torch`` measures any dtype ATen runs these products in (float64,
float32, bfloat16, float16; :data:`TORCH_DTYPES`), as the reference's
``jax`` takes any dtype it can represent; an operand of another dtype
raises and is never cast. ``cuda`` measures float32 only: its kernels
are float32. Both switch TF32 off, since a TF32 product would be a
different result under the float32 label, and both switch off cuBLAS's
reduced-precision reductions
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
and its fp16 twin), so a bfloat16 or float16 product accumulates in
float32 and is rounded once. Both settings are process-wide. The default
device is ``cuda``; without a card, constructing a backend without
``device="cpu"`` raises rather than quietly measuring the CPU.
Registration is the explicit call :func:`register_torch_backends`, which
also registers the host backends ``blas`` and ``numpy``
(:mod:`repro_torch.core.backends.blas`,
:mod:`repro_torch.core.backends.numpy_backend`).

The ``cuda`` backend runs each kernel under the launch a
:class:`~repro_torch.core.tuning.TuningTable` names for its dims (auto-
loaded for the card on first dispatch; ``REPRO_NO_TUNING`` kills it),
else under the wrapper's own launch rule.

On a card, ``time_algorithm`` times one captured CUDA graph of the
algorithm's walk, replayed: the counterpart of the reference's memo of
one jitted program per algorithm (``JaxBackend._jitted``). The host's
per-step work (the wrappers, the launch rules, allocation) stays out of
the measured quantity, as the reference keeps its Python out of a jitted
program. On the CPU the eager walk is timed.

The batched path (:meth:`TorchBackend.build_batched`,
:meth:`~TorchBackend.execute_batch`,
:meth:`~TorchBackend.time_algorithm_batched`) is the reference's vmap
path: one algorithm over a batch of operand sets stacked on one leading
axis. The walk is the same; every kernel takes the batch as a grid axis
of its own, so each step is one launch whatever the batch, and on a card
``time_algorithm_batched`` replays one captured graph of the batched
walk.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ...kernels import gemm_syrk as _gemm_syrk
from ...kernels import ops as kops
from ...kernels import ref
from .. import tuning as _tuning
from ..algorithms import Algorithm, Leaf
from ..arena import algorithm_structural_key
from ..fingerprint import HardwareFingerprint, device_label
from .base import (ExecutionBackend, KernelOps, backend_shard_mode,
                   register_backend, registered_backends)

#: Bound on the graphs one backend keeps, in count: the reference's
#: executable memo cap (``EXEC_MEMO_MAX``).
GRAPH_MEMO_MAX = 512
#: ... and in bytes of their private memory pools. A graph of one of the
#: paper's algorithms at dims <= 1200 holds one pool of the allocator's
#: 20 MB segments (tens of MB), so a family's sweep keeps a few hundred
#: graphs; 8 GiB is a tenth of the card's 80 GB and leaves the rest to
#: the operands, the kernels' outputs and a served model (Yi-9B: 17.7 GB)
#: in the same process.
GRAPH_MEMO_BYTES = 8 << 30


#: The dtype labels the ``torch`` backend measures, and their tensors'.
TORCH_DTYPES = {"float64": torch.float64, "float32": torch.float32,
                "bfloat16": torch.bfloat16, "float16": torch.float16}


def timing_mode(device: str, backend: Optional[str] = None) -> str:
    """What ``time_algorithm`` times for a fingerprint's device label and
    backend: ``"eager"``, the walk itself, for a host backend (``blas``,
    ``numpy``: the device label is then the host's ISA) and on the CPU;
    ``"graph"``, one captured CUDA graph replayed, on a card."""
    if device == "cpu":
        return "eager"
    if backend is not None:
        register_torch_backends()
        try:
            if backend_shard_mode(backend) == "process":
                return "eager"
        except KeyError:  # an unregistered label: a device, as before
            pass
    return "graph"


def fusion_enabled() -> bool:
    """Whether the ``cuda`` backend dispatches fused adjacent-step
    patterns: on unless ``REPRO_NO_FUSION`` is set."""
    return not os.environ.get("REPRO_NO_FUSION")


class TorchOps(KernelOps):
    """Plain ATen kernel vocabulary, one kernel per step (no fused
    patterns, like the reference's ``jax`` backend)."""

    def transpose(self, a):
        return a.mT

    def gemm(self, a, b):
        return ref.gemm(a, b)

    def syrk(self, a):
        return ref.syrk(a)

    def symm(self, s, b):
        return ref.symm(s, b)

    def symm_r(self, b, s):
        return b @ ref.tri2full(s)

    def tri2full(self, t):
        return ref.tri2full(t)


class CudaOps(TorchOps):
    """The hand-written kernels for the compute kinds; ``tri2full`` and
    transposition stay tensor ops (a transpose is a strided view the
    kernels read in place).

    ``config_lookup(kind, dims) -> dict | None`` supplies tuned launches
    (from a :class:`~repro_torch.core.tuning.TuningTable`, or the
    autotuner's per-candidate override), with dims read from the operands
    exactly as the reference's ``PallasOps`` reads them. Each entry goes
    through the kernel's ``config_from_dict``: one it refuses (a foreign
    or hand-edited entry) is dropped and the wrapper's launch rule picks.

    Advertises the fused ``gemm+gemm`` (``chain_gemm``) and ``gemm+syrk``
    (``gemm_syrk``) patterns unless ``REPRO_NO_FUSION`` is set, as the
    reference's ``pallas`` does.
    """

    _lookup: Optional[Callable[[str, Tuple[int, ...]], Optional[dict]]] = None

    def __init__(self, config_lookup: Optional[
            Callable[[str, Tuple[int, ...]], Optional[dict]]] = None):
        self._lookup = config_lookup

    def _cfg(self, kind: str, dims: Tuple[int, ...], t: torch.Tensor):
        """The tuned launch for ``(kind, dims)``, or None. A batched call
        (``t`` 3-D) takes the wrapper's launch rule: the table's entries
        were timed on one instance's grid."""
        if self._lookup is None or t.dim() == 3:
            return None
        entry = self._lookup(kind, dims)
        if not entry:
            return None
        limits = _tuning.CardLimits()
        if kind == "gemm_syrk" and t.is_cuda:
            limits = _tuning.CardLimits(
                active=_gemm_syrk.active_clusters(t.get_device()))
        return _tuning.launch_config(kind, dims, entry, limits)

    def fused_kinds(self) -> frozenset:
        if not fusion_enabled():
            return frozenset()
        return frozenset({"gemm+gemm", "gemm+syrk"})

    def gemm(self, a, b):
        cfg = self._cfg("gemm", (a.shape[-2], b.shape[-1], a.shape[-1]), a)
        return kops.gemm(a, b, config=cfg)

    def syrk(self, a):
        return kops.syrk(a, config=self._cfg(
            "syrk", (a.shape[-2], a.shape[-1]), a))

    def symm(self, s, b):
        return kops.symm(s, b, config=self._cfg(
            "symm", (s.shape[-2], b.shape[-1]), b))

    def symm_r(self, b, s):
        # B·S with S symmetric: (S·Bᵀ)ᵀ via the side-L kernel.
        cfg = self._cfg("symm", (s.shape[-2], b.shape[-2]), b)
        return kops.symm(s, b.mT, config=cfg).mT

    def tri2full(self, t):
        return kops.tri2full(t)

    def chain_gemm(self, a, b, c):
        cfg = self._cfg("chain_gemm", (a.shape[-2], a.shape[-1],
                                       b.shape[-1], c.shape[-1]), a)
        return kops.chain_gemm(a, b, c, config=cfg)

    def gemm_syrk(self, a, b):
        cfg = self._cfg("gemm_syrk", (a.shape[-2], a.shape[-1],
                                      b.shape[-1]), a)
        return kops.gemm_syrk(a, b, config=cfg)


@dataclasses.dataclass
class CapturedWalk:
    """One algorithm's walk captured on a card: the graph, its output
    (in the graph's private pool, rewritten by each replay), the kernel
    launches one replay makes, and the bytes its pool reserved."""

    graph: "torch.cuda.CUDAGraph"
    out: torch.Tensor
    launches: Mapping[str, int]
    nbytes: int


def batch_size(backend: str, alg: Algorithm,
               operands: Mapping[int, torch.Tensor]) -> int:
    """The batch of batched operands: each must be one matrix per
    instance on a single leading axis (the reference vmaps over one), and
    all must share its size; anything else raises ``ValueError``."""
    sizes = {}
    for base, t in sorted(operands.items()):
        if t.dim() != 3:
            raise ValueError(
                f"backend {backend!r} {alg.name}: operand {base} has shape "
                f"{tuple(t.shape)}; the batched path takes one leading "
                f"batch dim before the matrix dims")
        sizes[base] = t.shape[0]
    if len(set(sizes.values())) > 1:
        detail = ", ".join(f"operand {b}: {n}" for b, n in sizes.items())
        raise ValueError(f"backend {backend!r} {alg.name}: batch dim "
                         f"mismatch: {detail}")
    return next(iter(sizes.values()), 0)


class TorchBackend(ExecutionBackend):
    """Execute and time algorithms with plain ATen on one device."""

    name = "torch"
    default_dtype = "float32"
    dtypes = tuple(TORCH_DTYPES)
    shard_mode = "device"

    def __init__(self, device="cuda", reps: int = 3,
                 dtype: Optional[str] = None,
                 rng: Optional[np.random.Generator] = None,
                 seed: Optional[int] = None):
        super().__init__(reps=reps, dtype=dtype, rng=rng, seed=seed)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"backend {self.name!r}: no CUDA device is available; pass "
                f"device='cpu' to run on the CPU explicitly")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"backend {self.name!r}: unsupported device "
                             f"{self.device}")
        matmul = torch.backends.cuda.matmul
        matmul.allow_tf32 = False
        matmul.allow_bf16_reduced_precision_reduction = False
        matmul.allow_fp16_reduced_precision_reduction = False
        torch.backends.cudnn.allow_tf32 = False
        self.torch_dtype = TORCH_DTYPES[self.dtype]
        #: What a synthesized float64 leaf is rounded to on the host before
        #: it is placed: float64 stays, any other dtype goes through
        #: float32 (as the reference's numpy rounding does), so the arena's
        #: host buffers and a direct placement give the same bits.
        self.host_dtype = np.float64 if self.dtype == "float64" \
            else np.float32
        self.timing = timing_mode(device_label(self.device))
        # Graph memo: (structure, dims, inputs, generation) -> captured
        # walk, least recently used first.
        self._graphs: "collections.OrderedDict[Tuple, CapturedWalk]" = (
            collections.OrderedDict())
        self._graph_bytes = 0
        self._capture_stream: Optional[torch.cuda.Stream] = None
        self.memo_hits = 0
        self.memo_misses = 0

    def ops(self) -> KernelOps:
        return TorchOps()

    def _asarray(self, a: np.ndarray) -> torch.Tensor:
        # Round on the host (see host_dtype), then move and convert.
        host = torch.from_numpy(np.asarray(a).astype(self.host_dtype,
                                                     copy=False))
        return host.to(device=self.device, dtype=self.torch_dtype)

    def execute(self, alg: Algorithm, operands: Dict[int, object]):
        """The walk on ``operands``, each of which must be a tensor of the
        backend's dtype: another dtype raises rather than being cast."""
        for base, t in operands.items():
            if isinstance(t, torch.Tensor) and t.dtype != self.torch_dtype:
                raise ValueError(
                    f"backend {self.name!r} measures {self.dtype}, but "
                    f"operand {base} is {t.dtype}; it is not cast")
        return super().execute(alg, operands)

    # -- batched execution ---------------------------------------------------
    def make_batched_operands(self, alg: Algorithm,
                              batch: int) -> Dict[int, torch.Tensor]:
        """``batch`` independent operand sets, stacked on a leading axis."""
        return self.make_operands(alg, leading=(batch,))

    def _args(self, alg: Algorithm, operands: Mapping[int, object]) -> list:
        """Positional inputs of a built callable (chain leaf order); the
        walk fetches base positions only, so the rest are any operand."""
        some = next(iter(operands.values()))
        return [operands.get(i, some) for i in range(self.num_inputs(alg))]

    def build_batched(self, alg: Algorithm) -> Callable:
        """A positional callable evaluating ``alg`` over a batch of
        operand sets at once, each input (batch, rows, cols): the walk of
        :meth:`build`, one launch a kernel step whatever the batch."""
        fn = self.build(alg)
        name = self.name

        def batched(*inputs):
            batch_size(name, alg, dict(enumerate(inputs)))
            return fn(*inputs)

        return batched

    def execute_batch(self, alg: Algorithm,
                      operands: Dict[int, torch.Tensor]) -> torch.Tensor:
        """Evaluate ``alg`` over batched operands: (batch, rows, cols)."""
        batch_size(self.name, alg, operands)
        return self.execute(alg, operands)

    def time_algorithm_batched(self, alg: Algorithm, batch: int = 32,
                               operands: Optional[Dict[int, object]] = None,
                               reps: Optional[int] = None) -> float:
        """Median seconds of one *batched* evaluation of ``alg`` (on a
        card, one replay of the batched walk's captured graph). Divide by
        the batch for the per-instance time; against ``batch ×``
        :meth:`time_algorithm` it shows what one dispatch for the whole
        batch saves."""
        if operands is None:
            operands = self.make_batched_operands(alg, batch)
        batch_size(self.name, alg, operands)
        return self.time_algorithm(alg, operands, reps=reps)

    def _pre_rep(self) -> None:
        # The clock starts on an idle card.
        self._sync(None)

    def _sync(self, out):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def fingerprint(self) -> HardwareFingerprint:
        """What this backend's measurements are valid for."""
        return HardwareFingerprint(self.name, device_label(self.device),
                                   self.dtype)

    # -- graph timing ------------------------------------------------------
    def _memo_generation(self) -> Tuple:
        """What a captured walk bakes in beyond its structure and inputs:
        the fused patterns dispatched, so flipping ``REPRO_NO_FUSION``
        mid-process never replays a stale graph (the reference folds the
        same switch into its memo key)."""
        return tuple(sorted(self.ops().fused_kinds()))

    def _timed_callable(self, alg: Algorithm, operands: Dict[int, object]
                        ) -> Callable[[], object]:
        """On a card, a replay of the algorithm's captured walk; on the
        CPU, the eager walk.

        A graph bakes in its inputs' addresses and every shape, so the
        memo key is the algorithm's structure, its calls' dims, each input's
        pointer, shape and strides, and :meth:`_memo_generation`. On a miss
        the walk runs once eagerly (building the kernels and setting their
        attributes), then is captured; ``time_algorithm`` then warms up
        with one replay and times ``reps`` more. A capture that fails
        raises: there is no eager fallback.
        """
        if self.timing == "eager":
            return super()._timed_callable(alg, operands)
        entry = self._graph(alg, operands)
        graph, credit, out = entry.graph, entry.launches, entry.out

        def replay():
            graph.replay()
            kops.add_launches(credit)
            return out

        return replay

    def _graph(self, alg: Algorithm,
               operands: Dict[int, object]) -> CapturedWalk:
        bases = sorted({ref.base for step in alg.steps
                        for ref in (step.lhs, step.rhs)
                        if isinstance(ref, Leaf) and ref.base in operands})
        key = (algorithm_structural_key(alg),
               tuple(call.dims for call in alg.calls),
               tuple((b, operands[b].data_ptr(), tuple(operands[b].shape),
                      operands[b].stride()) for b in bases),
               self._memo_generation())
        entry = self._graphs.get(key)
        if entry is not None:
            self.memo_hits += 1
            self._graphs.move_to_end(key)
            return entry
        self.memo_misses += 1
        entry = self._capture(alg, operands)
        self._graphs[key] = entry
        self._graph_bytes += entry.nbytes
        if len(self._graphs) > GRAPH_MEMO_MAX or \
                self._graph_bytes > GRAPH_MEMO_BYTES:
            # Evict the least recently used quarter at once, then hand
            # their pools back: a released graph's pool is freed only by
            # empty_cache (or when an allocation fails, which inside a
            # later capture would invalidate it).
            while len(self._graphs) > 1 and (
                    len(self._graphs) > GRAPH_MEMO_MAX * 3 // 4
                    or self._graph_bytes > GRAPH_MEMO_BYTES * 3 // 4):
                self._graph_bytes -= self._graphs.popitem(
                    last=False)[1].nbytes
            torch.cuda.empty_cache()
        return entry

    def _capture(self, alg: Algorithm,
                 operands: Dict[int, object]) -> CapturedWalk:
        """Run the walk once eagerly, then capture it into a graph of its
        own (with a private memory pool), on a side stream ordered after
        the work already queued on the current one."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            self.execute(alg, operands)
            before = kops.launch_counts()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="global")
            try:
                out = self.execute(alg, operands)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is already invalid; report the cause
                raise
            graph.capture_end()
            nbytes = max(0, torch.cuda.memory_reserved(self.device)
                         - reserved)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        after = kops.launch_counts()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        # The capture executed nothing: take its counts back.
        kops.add_launches({k: -n for k, n in launches.items()})
        return CapturedWalk(graph, out, launches, nbytes)


class CudaBackend(TorchBackend):
    """Execute and time algorithms through the hand-written CUDA kernels.

    Tuning: with ``tuning="auto"`` (the default) the backend loads the
    :class:`~repro_torch.core.tuning.TuningTable` cached for its
    fingerprint (written by ``calibrate --tune``) on first dispatch; a
    kernel whose dims the table holds then runs under that entry's
    launch. Unseen dims keep the wrapper's launch rule: unlike the
    reference's ``TuningTable.config``, dispatch borrows no nearest
    entry, because the launch rule is a cost model fitted on this card
    and a config tuned at other dims ran slower than it there (PERF.md
    §6). Pass a table, or ``tuning=None`` to pin the wrappers' launch
    rules; ``REPRO_NO_TUNING=1`` kills lookups at dispatch regardless.
    :meth:`tuning_override` is the autotuner's hook and wins over both.
    """

    name = "cuda"
    #: The kernels are float32 only: any other label raises, and never
    #: falls back to the ``torch`` backend.
    dtypes = ("float32",)
    supports_tuning = True

    def __init__(self, device="cuda", reps: int = 3,
                 dtype: Optional[str] = None,
                 rng: Optional[np.random.Generator] = None,
                 seed: Optional[int] = None, tuning="auto"):
        super().__init__(device=device, reps=reps, dtype=dtype, rng=rng,
                         seed=seed)
        self._tuning = tuning          # "auto" | TuningTable | None
        self._tuning_resolved = tuning != "auto"
        self._override: Optional[Callable[
            [str, Tuple[int, ...]], Optional[dict]]] = None
        #: Bumped whenever the effective lookup changes (table swap,
        #: override entry and exit): a captured graph bakes in its
        #: launches, so the graph memo keys on it.
        self._tuning_generation = 0

    def set_tuning(self, table) -> None:
        """Pin a :class:`~repro_torch.core.tuning.TuningTable` (or None)."""
        self._tuning = table
        self._tuning_resolved = True
        self._tuning_generation += 1

    def tuning_table(self):
        """The resolved table (auto-load happens here), or ``None``."""
        if not self._tuning_resolved:
            self._tuning = _tuning.load_default_tuning_table(
                backend=self.name, dtype=self.dtype, device=self.device)
            self._tuning_resolved = True
        return self._tuning

    @contextlib.contextmanager
    def tuning_override(self, entries: Dict[Tuple[str, Tuple[int, ...]],
                                            dict]):
        """Force exact per-``(kind, dims)`` configs for the duration.

        The autotuner's measurement hook: candidates run through the same
        lookup production dispatch uses, bypassing the table and the
        kill-switch (a tuning run measures while ``REPRO_NO_TUNING``
        protects production traffic). Entry and exit bump the tuning
        generation, so no graph captured under one candidate is replayed
        under another.
        """
        prev = self._override
        self._override = lambda kind, dims: entries.get((kind, dims))
        self._tuning_generation += 1
        try:
            yield self
        finally:
            self._override = prev
            self._tuning_generation += 1

    def _config_lookup(self, kind: str,
                       dims: Tuple[int, ...]) -> Optional[dict]:
        if self._override is not None:
            return self._override(kind, dims)
        if _tuning.tuning_disabled():
            return None
        table = self.tuning_table()
        entry = None if table is None else table.entry(kind, dims)
        return None if entry is None else dict(entry.config)

    def _memo_generation(self) -> Tuple:
        """Fusion and tuning state a captured walk bakes in: the fused
        patterns, the kill-switch and the tuning generation."""
        return super()._memo_generation() + (_tuning.tuning_disabled(),
                                             self._tuning_generation)

    def ops(self) -> KernelOps:
        return CudaOps(self._config_lookup)


def register_torch_backends() -> None:
    """Register the port's four backends (idempotent): ``torch`` and
    ``cuda`` on a device, ``blas`` and ``numpy`` on the host."""
    from .blas import BlasBackend
    from .numpy_backend import NumpyBackend

    known = registered_backends()
    for cls in (TorchBackend, CudaBackend, BlasBackend, NumpyBackend):
        if cls.name not in known:
            register_backend(cls.name, cls)
