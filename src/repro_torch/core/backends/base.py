"""The execution-backend protocol, the generic step walker, and the registry.

The PyTorch port's counterpart of the reference package's
``core/backends/base.py``. The paper's anomalies are a property of the
*kernel implementation*, not the math, so every executor speaks one
interface:

* :class:`KernelOps` — a backend's kernel vocabulary: one callable per
  :data:`~repro_torch.core.flops.KERNEL_KINDS` entry (plus ``transpose``
  and the optional fused ``chain_gemm``).
* :func:`walk_steps` — the one DAG walker, parameterized by
  :class:`KernelOps`; adjacent fusable steps dispatch to one fused launch.
* :class:`ExecutionBackend` — ``make_operands`` / ``execute`` /
  ``build`` / ``time_algorithm`` / ``benchmark_call``, implemented
  generically on the walker; backends override operand placement
  (``_asarray``) and device synchronisation (``_sync``).
* :func:`register_backend` / :func:`get_backend` /
  :func:`registered_backends` — the registry the sweep resolves backends
  through. The key doubles as the fingerprint ``backend`` string.
"""

from __future__ import annotations

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
        """Fused step patterns this vocabulary implements (default none)."""
        return frozenset()

    def chain_gemm(self, a, b, c):
        """Fused ``(a·b)·c`` (pattern ``"gemm+gemm"``)."""
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
    materialization is what the fusion deletes):

    * ``"gemm+gemm"`` — ``second`` is a gemm with ``lhs == X``;
    * ``"gemm+syrk"`` — ``second`` is a syrk on ``X``.
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
    ``ops.fused_kinds()`` advertises ``"gemm+gemm"``, adjacent steps
    matching :func:`fusable_pattern` run as one ``ops.chain_gemm`` launch.
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
            if pattern == "gemm+gemm" and pattern in fused:
                nxt = steps[i + 1]
                out = ops.chain_gemm(fetch(step.lhs), fetch(step.rhs),
                                     fetch(nxt.rhs))
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
    ``backend`` string), ``default_dtype`` and ``dtypes``, then override
    ``ops()`` and, where operands live on a device, ``_asarray`` and
    ``_sync``.
    """

    name: str = "abstract"
    default_dtype: str = "float32"
    #: Allowed dtype labels; ``None`` means any.
    dtypes: Optional[Tuple[str, ...]] = None

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

    def _sync(self) -> None:
        """Block until all work queued on the backend's device is done."""

    # -- the protocol ------------------------------------------------------
    def make_operands(self, alg: Algorithm) -> Dict[int, object]:
        """Fresh random inputs for every distinct leaf *base* of ``alg``."""
        out: Dict[int, object] = {}
        for step in alg.steps:
            for ref in (step.lhs, step.rhs):
                if isinstance(ref, Leaf) and ref.base not in out:
                    out[ref.base] = self.make_leaf_operand(ref)
        return out

    def make_leaf_operand(self, ref: Leaf) -> object:
        """One leaf's operand buffer (untransposed, symmetrized, placed).

        Draws float64 normals from ``default_rng((seed, base, r, c))``
        (or the backend's ``rng`` without a seed), symmetrizes symmetric
        leaves, then hands the array to ``_asarray`` — bit for bit what
        the reference package's backends draw.
        """
        r, c = (ref.cols, ref.rows) if ref.transposed else (
            ref.rows, ref.cols)
        rng = self.rng if self.seed is None else np.random.default_rng(
            (self.seed, ref.base, r, c))
        a = rng.standard_normal((r, c))
        if ref.symmetric:
            a = (a + np.swapaxes(a, -1, -2)) / 2.0
        return self._asarray(a)

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

        The device is synchronised before the clock is read at both ends
        of every repetition, so the time is that of the work itself and
        not of its enqueueing (the reference's ``block_until_ready``).
        """
        if operands is None:
            operands = self.make_operands(alg)
        reps = self.reps if reps is None else reps
        self.execute(alg, operands)  # warm-up: kernel build / page-in
        ts: List[float] = []
        for _ in range(reps):
            self._sync()
            t0 = time.perf_counter()
            self.execute(alg, operands)
            self._sync()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    def benchmark_call(self, call: KernelCall,
                       reps: Optional[int] = None) -> float:
        """Time one kernel call in isolation (synthetic one-step algorithm)."""
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


def registered_backends() -> List[str]:
    return sorted(_REGISTRY)
