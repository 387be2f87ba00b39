"""The execution-backend protocol, the generic step walker, and the registry.

The PyTorch port's counterpart of the reference package's
``core/backends/base.py``. The paper's anomalies are a property of the
*kernel implementation*, not the math, so every executor speaks one
interface:

* :class:`KernelOps` — a backend's kernel vocabulary: one callable per
  :data:`~repro_torch.core.flops.KERNEL_KINDS` entry (plus ``transpose``
  and the optional fused ``chain_gemm`` and ``gemm_syrk``).
* :func:`walk_steps` — the one DAG walker, parameterized by
  :class:`KernelOps`; adjacent fusable steps dispatch to one fused launch.
* :func:`synthetic_algorithm` / :func:`synthetic_fused_algorithm` — one
  kernel call, or one fused pair, as an algorithm, so a single launch is
  timed through the same ``time_algorithm`` path as whole algorithms.
* :class:`ExecutionBackend` — ``make_operands`` / ``execute`` /
  ``build`` / ``time_algorithm`` / ``benchmark_call``, implemented
  generically on the walker; backends override operand placement
  (``_asarray``), per-repetition setup (``_pre_rep``), device
  synchronisation (``_sync``) and what is timed (``_timed_callable``).
* :func:`register_backend` / :func:`get_backend` / :func:`make_backend` /
  :func:`registered_backends` — the registry the sweep resolves backends
  through. The key doubles as the fingerprint ``backend`` string.
"""

from __future__ import annotations

import inspect
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..algorithms import Algorithm, Leaf, Step
from ..flops import KernelCall


class KernelOps:
    """Per-backend kernel vocabulary the generic walker dispatches to.

    ``symm``/``symm_r`` receive the symmetric operand as ``s`` (stored as
    its lower triangle — implementations must not read above the
    diagonal) and the dense operand as ``b``; ``syrk`` returns the lower
    triangle of ``a·aᵀ`` (``tri`` storage); ``tri2full`` mirrors a lower
    triangle into a full matrix.
    """

    def transpose(self, a):
        raise NotImplementedError

    def gemm(self, a, b):
        raise NotImplementedError

    def syrk(self, a):
        raise NotImplementedError

    def symm(self, s, b):
        """S·B with S symmetric (side L)."""
        raise NotImplementedError

    def symm_r(self, b, s):
        """B·S with S symmetric (side R)."""
        raise NotImplementedError

    def tri2full(self, t):
        raise NotImplementedError

    def fused_kinds(self) -> frozenset:
        """Fused step patterns this vocabulary implements (default none).

        The walker consults this before dispatching: when two adjacent
        steps match an advertised pattern (see :func:`fusable_pattern`),
        it calls the fused method instead of the two single-kind ones.
        """
        return frozenset()

    def chain_gemm(self, a, b, c):
        """Fused ``(a·b)·c`` (pattern ``"gemm+gemm"``)."""
        raise NotImplementedError

    def gemm_syrk(self, a, b):
        """Fused lower triangle of ``(a·b)(a·b)ᵀ`` (``"gemm+syrk"``)."""
        raise NotImplementedError


def _fetched_refs(step: Step) -> tuple:
    """The operand refs ``walk_steps`` actually fetches for ``step``.

    syrk/tri2full fetch only ``lhs``; a syrk step's ``rhs`` may carry a
    provenance twin that is never materialized.
    """
    if step.call.kind in ("gemm", "symm"):
        return (step.lhs, step.rhs)
    return (step.lhs,)


def fusable_pattern(first: Step, second: Step,
                    rest: Sequence[Step]) -> Optional[str]:
    """Which fused pattern ``(first, second)`` matches, if any.

    ``first`` must be a gemm whose output ``X`` is consumed *only* as
    ``second``'s left operand and never fetched by any later step (its
    materialization in device memory is what the fusion deletes):

    * ``"gemm+gemm"`` — ``second`` is a gemm with ``lhs == X``
      (``(A·B)·C``, the ``chain_gemm`` kernel);
    * ``"gemm+syrk"`` — ``second`` is a syrk on ``X``
      (``tril((A·B)(A·B)ᵀ)``, the ``gemm_syrk`` kernel).
    """
    if first.call.kind != "gemm":
        return None
    x = first.out
    for later in rest:
        for ref in _fetched_refs(later):
            if not isinstance(ref, Leaf) and ref == x:
                return None
    second_lhs_is_x = not isinstance(second.lhs, Leaf) and second.lhs == x
    if second.call.kind == "gemm" and second_lhs_is_x and (
            isinstance(second.rhs, Leaf) or second.rhs != x):
        return "gemm+gemm"
    if second.call.kind == "syrk" and second_lhs_is_x:
        return "gemm+syrk"
    return None


def walk_steps(steps: Sequence[Step], leaf_fetch: Callable[[int], object],
               ops: KernelOps):
    """Execute an algorithm's step DAG with one backend's kernels.

    ``leaf_fetch(base)`` returns the *untransposed* operand for a leaf
    base index; transposition is applied here via ``ops.transpose`` (a
    strided view for tensors, so no copy is made). When
    ``ops.fused_kinds()`` advertises a pattern, adjacent steps matching
    it (:func:`fusable_pattern`) run as one launch: ``"gemm+gemm"`` as
    ``ops.chain_gemm``, ``"gemm+syrk"`` as ``ops.gemm_syrk``. The fused
    intermediate is dead by the pattern's definition, so only the second
    step's output id is bound.
    """
    inter: Dict[int, object] = {}

    def fetch(ref):
        if isinstance(ref, Leaf):
            a = leaf_fetch(ref.base)
            return ops.transpose(a) if ref.transposed else a
        return inter[ref]

    fused = ops.fused_kinds()
    out = None
    i = 0
    n = len(steps)
    while i < n:
        step = steps[i]
        if fused and i + 1 < n:
            pattern = fusable_pattern(step, steps[i + 1], steps[i + 2:])
            if pattern is not None and pattern in fused:
                nxt = steps[i + 1]
                if pattern == "gemm+gemm":
                    out = ops.chain_gemm(fetch(step.lhs), fetch(step.rhs),
                                         fetch(nxt.rhs))
                else:
                    out = ops.gemm_syrk(fetch(step.lhs), fetch(step.rhs))
                inter[nxt.out] = out
                i += 2
                continue
        kind = step.call.kind
        if kind == "gemm":
            out = ops.gemm(fetch(step.lhs), fetch(step.rhs))
        elif kind == "syrk":
            out = ops.syrk(fetch(step.lhs))
        elif kind == "symm":
            if step.symm_side == "R":
                out = ops.symm_r(fetch(step.lhs), fetch(step.rhs))
            else:
                out = ops.symm(fetch(step.lhs), fetch(step.rhs))
        elif kind == "tri2full":
            out = ops.tri2full(fetch(step.lhs))
        else:
            raise ValueError(kind)
        inter[step.out] = out
        i += 1
    return out


def num_inputs(alg: Algorithm) -> int:
    """Positional arity of a built callable: max leaf *index* + 1."""
    mx = -1
    for step in alg.steps:
        for ref in (step.lhs, step.rhs):
            if isinstance(ref, Leaf):
                mx = max(mx, ref.index)
    return mx + 1


def synthetic_algorithm(call: KernelCall) -> Algorithm:
    """A one-step algorithm exercising exactly one kernel call, so
    ``benchmark_call`` runs through the same path as whole algorithms."""
    if call.kind == "gemm":
        m, n, k = call.dims
        a = Leaf(index=0, base=0, transposed=False, rows=m, cols=k)
        b = Leaf(index=1, base=1, transposed=False, rows=k, cols=n)
        step = Step(call=call, lhs=a, rhs=b, out=0, out_rows=m, out_cols=n,
                    out_storage="full", out_symmetric=False)
    elif call.kind == "syrk":
        m, k = call.dims
        a = Leaf(index=0, base=0, transposed=False, rows=m, cols=k)
        step = Step(call=call, lhs=a, rhs=None, out=0, out_rows=m,
                    out_cols=m, out_storage="tri", out_symmetric=True)
    elif call.kind == "symm":
        m, n = call.dims
        s = Leaf(index=0, base=0, transposed=False, rows=m, cols=m,
                 symmetric=True)
        b = Leaf(index=1, base=1, transposed=False, rows=m, cols=n)
        step = Step(call=call, lhs=s, rhs=b, out=0, out_rows=m, out_cols=n,
                    out_storage="full", out_symmetric=False)
    elif call.kind == "tri2full":
        (m,) = call.dims
        t = Leaf(index=0, base=0, transposed=False, rows=m, cols=m,
                 storage="tri")
        step = Step(call=call, lhs=t, rhs=None, out=0, out_rows=m,
                    out_cols=m, out_storage="full", out_symmetric=True)
    else:
        raise ValueError(call.kind)
    return Algorithm(name=f"bench_{call.kind}", steps=(step,))


def synthetic_fused_algorithm(kind: str, dims: Sequence[int]) -> Algorithm:
    """A two-step algorithm exercising exactly one fused pattern.

    The step pair matches :func:`fusable_pattern`, so a backend that
    advertises the pattern times the fused launch and any other backend
    times the two-kernel form — one Algorithm measures both sides of the
    fusion trade.

    * ``"chain_gemm"``, dims ``(m, k, l, n)`` — ``(A·B)·C`` with
      A ``(m,k)``, B ``(k,l)``, C ``(l,n)``;
    * ``"gemm_syrk"``, dims ``(m, k, l)`` — ``tril((A·B)(A·B)ᵀ)`` with
      A ``(m,k)``, B ``(k,l)``.
    """
    if kind == "chain_gemm":
        m, k, l, n = dims
        a = Leaf(index=0, base=0, transposed=False, rows=m, cols=k)
        b = Leaf(index=1, base=1, transposed=False, rows=k, cols=l)
        c = Leaf(index=2, base=2, transposed=False, rows=l, cols=n)
        s1 = Step(call=KernelCall("gemm", (m, l, k)), lhs=a, rhs=b, out=0,
                  out_rows=m, out_cols=l, out_storage="full",
                  out_symmetric=False)
        s2 = Step(call=KernelCall("gemm", (m, n, l)), lhs=0, rhs=c, out=1,
                  out_rows=m, out_cols=n, out_storage="full",
                  out_symmetric=False)
    elif kind == "gemm_syrk":
        m, k, l = dims
        a = Leaf(index=0, base=0, transposed=False, rows=m, cols=k)
        b = Leaf(index=1, base=1, transposed=False, rows=k, cols=l)
        s1 = Step(call=KernelCall("gemm", (m, l, k)), lhs=a, rhs=b, out=0,
                  out_rows=m, out_cols=l, out_storage="full",
                  out_symmetric=False)
        s2 = Step(call=KernelCall("syrk", (m, l)), lhs=0, rhs=None, out=1,
                  out_rows=m, out_cols=m, out_storage="tri",
                  out_symmetric=True)
    else:
        raise ValueError(
            f"unknown fused pattern {kind!r}; expected 'chain_gemm' or "
            f"'gemm_syrk'")
    return Algorithm(name=f"bench_{kind}", steps=(s1, s2))


def operands_from_numpy(operands: Mapping[int, np.ndarray],
                        device) -> Dict[int, torch.Tensor]:
    """Base-indexed numpy operands (e.g. the reference package's, via
    ``np.asarray``) as float32 tensors on ``device``."""
    return {base: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=device)
            for base, a in operands.items()}


class ExecutionBackend:
    """Base class + protocol for one way of executing algorithms.

    Subclasses set ``name`` (the registry key — also the fingerprint
    ``backend`` string), ``default_dtype``, ``dtypes`` and ``shard_mode``
    (``"process"`` for backends the sweep engine fans out over worker
    processes, ``"device"`` for backends it fans out one process per
    card), then override the hooks they need:

    * ``ops()``             — the :class:`KernelOps` (required);
    * ``_asarray(a)``       — dtype/device placement of operands;
    * ``_pre_rep()``        — per-repetition setup before the clock starts;
    * ``_sync(out)``        — block until ``out`` is computed;
    * ``_timed_callable()`` — what ``time_algorithm`` times.
    """

    name: str = "abstract"
    default_dtype: str = "float32"
    #: Allowed dtype labels; ``None`` means any.
    dtypes: Optional[Tuple[str, ...]] = None
    shard_mode: str = "process"
    #: Whether the kernels take launch configs ``calibrate --tune`` can
    #: search (``tuning_override`` / ``set_tuning`` / ``tuning_table``).
    supports_tuning: bool = False

    def __init__(self, reps: int = 3, dtype: Optional[str] = None,
                 rng: Optional[np.random.Generator] = None,
                 seed: Optional[int] = None):
        dtype = dtype or self.default_dtype
        if self.dtypes is not None and dtype not in self.dtypes:
            raise ValueError(
                f"backend {self.name!r} measures {'/'.join(self.dtypes)}; "
                f"got dtype={dtype!r} — a different label would stamp a "
                f"fingerprint the measurements don't match")
        self.reps = reps
        self.dtype = dtype
        #: With ``seed`` set, each leaf operand's content is a pure
        #: function of ``(seed, base, shape)`` — the same draw the
        #: reference package makes, so both build identical inputs.
        self.seed = seed
        self.rng = rng or np.random.default_rng(0)

    # -- subclass hooks ---------------------------------------------------
    def ops(self) -> KernelOps:
        raise NotImplementedError

    def _asarray(self, a: np.ndarray):
        """Place one freshly synthesized operand (dtype/device)."""
        return a

    def _pre_rep(self) -> None:
        """Per-repetition setup before the clock starts."""

    def _sync(self, out):
        """Block until ``out`` is computed on the backend's device."""
        return out

    def _timed_callable(self, alg: Algorithm, operands: Dict[int, object]
                        ) -> Callable[[], object]:
        """The zero-argument callable ``time_algorithm`` times per
        repetition: here the eager walk."""
        return lambda: self.execute(alg, operands)

    # -- the protocol ------------------------------------------------------
    def fingerprint_tags(self) -> Tuple[str, str]:
        """(backend, dtype) labels profiles and atlases are keyed by."""
        return (self.name, self.dtype)

    def make_operands(self, alg: Algorithm) -> Dict[int, object]:
        """Fresh random inputs for every distinct leaf *base* of ``alg``."""
        out: Dict[int, object] = {}
        for step in alg.steps:
            for ref in (step.lhs, step.rhs):
                if isinstance(ref, Leaf) and ref.base not in out:
                    out[ref.base] = self.make_leaf_operand(ref)
        return out

    def synthesize_leaf(self, ref: Leaf) -> np.ndarray:
        """One leaf's operand on the host, before placement: float64
        normals from ``default_rng((seed, base, r, c))`` (or the backend's
        ``rng`` without a seed), symmetrized for symmetric leaves — bit
        for bit what the reference package's backends draw. It touches no
        device, so a helper thread may call it while the card is timed."""
        r, c = (ref.cols, ref.rows) if ref.transposed else (
            ref.rows, ref.cols)
        rng = self.rng if self.seed is None else np.random.default_rng(
            (self.seed, ref.base, r, c))
        a = rng.standard_normal((r, c))
        if ref.symmetric:
            a = (a + np.swapaxes(a, -1, -2)) / 2.0
        return a

    def make_leaf_operand(self, ref: Leaf) -> object:
        """One leaf's operand buffer (untransposed, symmetrized, placed):
        :meth:`synthesize_leaf` handed to ``_asarray``."""
        return self._asarray(self.synthesize_leaf(ref))

    def execute(self, alg: Algorithm, operands: Dict[int, object]):
        """Evaluate ``alg`` on base-indexed operands via the one walker."""
        return walk_steps(alg.steps, operands.__getitem__, self.ops())

    def build(self, alg: Algorithm) -> Callable:
        """A positional callable ``fn(*inputs)`` evaluating ``alg``
        (inputs follow chain leaf order, see :func:`num_inputs`)."""
        ops = self.ops()
        steps = alg.steps

        def fn(*inputs):
            return walk_steps(steps, inputs.__getitem__, ops)

        return fn

    def time_algorithm(self, alg: Algorithm,
                       operands: Optional[Dict[int, object]] = None,
                       reps: Optional[int] = None) -> float:
        """Median-of-reps wall seconds, warm-up excluded.

        ``_timed_callable`` gives what is timed; one call of it warms up,
        then each repetition runs ``_pre_rep`` before the clock starts and
        ``_sync`` before it stops, so the time is that of the work itself
        and not of its enqueueing (the reference's ``block_until_ready``).
        """
        if operands is None:
            operands = self.make_operands(alg)
        reps = self.reps if reps is None else reps
        fn = self._timed_callable(alg, operands)
        self._sync(fn())  # warm-up
        ts: List[float] = []
        for _ in range(reps):
            self._pre_rep()
            t0 = time.perf_counter()
            self._sync(fn())
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    def benchmark_call(self, call: KernelCall,
                       reps: Optional[int] = None) -> float:
        """Time one kernel call in isolation (synthetic one-step algorithm)
        — ``time_algorithm`` on :func:`synthetic_algorithm`, so the same
        protocol by construction."""
        return self.time_algorithm(synthetic_algorithm(call), reps=reps)


# ---------------------------------------------------------------- registry --

_REGISTRY: Dict[str, Callable[..., ExecutionBackend]] = {}


def register_backend(name: str, factory: Callable[..., ExecutionBackend],
                     ) -> Callable[..., ExecutionBackend]:
    """Register a backend class/factory under ``name`` (the fingerprint key).

    Duplicate names are rejected: silently shadowing an entry would re-key
    every atlas on disk.
    """
    key = name.lower()
    if key in _REGISTRY:
        raise ValueError(f"execution backend {key!r} is already registered")
    _REGISTRY[key] = factory
    return factory


def get_backend_class(name: str) -> Callable[..., ExecutionBackend]:
    """Resolve a registry name to its backend class/factory."""
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown execution backend {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def get_backend(name: str, **options) -> ExecutionBackend:
    """Instantiate a registered backend (unknown options raise)."""
    return get_backend_class(name)(**options)


def make_backend(name: str, **options) -> ExecutionBackend:
    """CLI-lenient :func:`get_backend`: drops options the backend lacks.

    Generic front ends pass one option superset (``reps``,
    ``flush_cache``, ``dtype``, ``device``, ``seed``) and each backend
    takes what its constructor declares: ``--no-flush`` reaches no device
    backend, as in the reference. Module-level, so a
    ``functools.partial`` of it pickles into worker processes.
    """
    cls = get_backend_class(name)
    try:
        params = inspect.signature(cls).parameters
    except (TypeError, ValueError):  # pragma: no cover - exotic factory
        return cls(**options)
    if not any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values()):
        options = {k: v for k, v in options.items() if k in params}
    return cls(**options)


def registered_backends() -> List[str]:
    return sorted(_REGISTRY)


def backend_default_dtype(name: str) -> str:
    """Default fingerprint dtype of a registered backend."""
    return getattr(get_backend_class(name), "default_dtype", "float32")


def backend_shard_mode(name: str) -> str:
    """How the sweep engine fans this backend out: process | device."""
    return getattr(get_backend_class(name), "shard_mode", "process")


def measure_seconds(fn: Callable, *args) -> tuple:
    """Run ``fn(*args)`` and wait for its result; (result, seconds).

    Used by the planner's online refinement, so the recorded time is the
    work's completion, not its enqueueing: a result on a card is
    synchronised before the second clock read. A deferred CUDA error
    surfaced by the synchronise propagates — recording the enqueue time
    of a failed computation would poison the profile.
    """
    t0 = time.perf_counter()
    out = fn(*args)
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out, time.perf_counter() - t0
