"""The ``numpy`` backend: the float64 oracle, as a backend of its own.

The port's copy of the reference package's
``core/backends/numpy_backend.py`` (numpy only). Semantically the
``blas`` backend with ``@`` and ``tril`` in place of scipy: the ground
truth the other backends' results are held against
(:func:`reference_execute`), and as a timing backend what numpy's own
matmul dispatch does with the same step DAGs, flushing the cache before
each repetition as ``blas`` does. Its anomaly regions are not the
paper's; ``sweep --compare-backends`` reports the difference.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..algorithms import Algorithm
from .base import ExecutionBackend, KernelOps, walk_steps
from .blas import CacheFlusher


def _mirror_lower(t: np.ndarray) -> np.ndarray:
    return np.tril(t) + np.tril(t, -1).T


class NumpyOps(KernelOps):
    """numpy kernel vocabulary honouring triangle storage."""

    def transpose(self, a):
        return a.T

    def gemm(self, a, b):
        return a @ b

    def syrk(self, a):
        return np.tril(a @ a.T)

    def symm(self, s, b):
        return _mirror_lower(s) @ b

    def symm_r(self, b, s):
        return b @ _mirror_lower(s)

    def tri2full(self, t):
        return _mirror_lower(t)


_OPS = NumpyOps()


class NumpyBackend(ExecutionBackend):
    """numpy in float64 on the host: the oracle, and a timing backend."""

    name = "numpy"
    default_dtype = "float64"
    dtypes = ("float64",)
    shard_mode = "process"

    def __init__(self, reps: int = 10, flush_cache: bool = True,
                 rng: Optional[np.random.Generator] = None,
                 dtype: Optional[str] = None,
                 seed: Optional[int] = None):
        super().__init__(reps=reps, dtype=dtype, rng=rng, seed=seed)
        self.flusher = CacheFlusher() if flush_cache else None

    def ops(self) -> KernelOps:
        return _OPS

    def _pre_rep(self) -> None:
        if self.flusher:
            self.flusher.flush()


def reference_execute(alg: Algorithm,
                      operands: Dict[int, np.ndarray]) -> np.ndarray:
    """Stateless oracle executor for an algorithm's step sequence.

    Honours triangle storage (a SYRK output keeps only its lower
    triangle; SYMM and TRI2FULL read only the lower triangle of a
    symmetric operand) and SYMM sides. ``NumpyBackend().execute`` with no
    instance to construct; operands are converted with ``np.asarray``.
    """
    return walk_steps(alg.steps,
                      lambda base: np.asarray(operands[base]), _OPS)
