"""The ``blas`` backend: scipy BLAS kernels, the paper's measurement
protocol.

The port's copy of the reference package's ``core/backends/blas.py``
(numpy and scipy only): double precision, Fortran-order operands,
dgemm/dsyrk/dsymm through :mod:`scipy.linalg.blas`, a cache flush before
every repetition (paper §3.4) and the median of ``reps`` timings. Its
anomaly regions are the ones that correspond to the paper's. It runs on
the host, so its fingerprint names the host's ISA, as the reference's
does, and ``sweep --shards N`` fans it out over worker processes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .base import ExecutionBackend, KernelOps

try:
    from scipy.linalg import blas as _blas
except ImportError:  # pragma: no cover - scipy is a dependency
    _blas = None


#: Bytes the flush touches: more than the last-level cache of the hosts
#: the paper and this port measure on.
FLUSH_BYTES = 64 * 1024 * 1024


class CacheFlusher:
    """Paper §3.4: flush the cache before each repetition."""

    def __init__(self, nbytes: int = FLUSH_BYTES):
        self._buf = np.zeros(nbytes // 8, dtype=np.float64)

    def flush(self) -> None:
        # Touch every cache line; the sum defeats dead-code elimination.
        self._buf += 1.0
        _ = float(self._buf[::4096].sum())


class BlasOps(KernelOps):
    """scipy BLAS kernel vocabulary (float64, triangle-aware)."""

    def transpose(self, a):
        return a.T

    def gemm(self, a, b):
        return _blas.dgemm(1.0, a, b)

    def syrk(self, a):
        # dsyrk computes one triangle of a·aᵀ (lower, given lower=1).
        return _blas.dsyrk(1.0, a, lower=1)

    def symm(self, s, b):
        return _blas.dsymm(1.0, s, b, side=0, lower=1)

    def symm_r(self, b, s):
        # dsymm(side=1) computes b·s with s the symmetric operand.
        return _blas.dsymm(1.0, s, b, side=1, lower=1)

    def tri2full(self, t):
        return np.asfortranarray(np.tril(t) + np.tril(t, -1).T)


_OPS = BlasOps()


class BlasBackend(ExecutionBackend):
    """scipy BLAS in float64 on the host, the paper's protocol."""

    name = "blas"
    default_dtype = "float64"
    dtypes = ("float64",)
    shard_mode = "process"

    def __init__(self, reps: int = 10, flush_cache: bool = True,
                 rng: Optional[np.random.Generator] = None,
                 dtype: Optional[str] = None,
                 seed: Optional[int] = None):
        if _blas is None:  # pragma: no cover - scipy is a dependency
            raise RuntimeError("scipy BLAS is unavailable; the blas "
                               "backend has no other implementation")
        super().__init__(reps=reps, dtype=dtype, rng=rng, seed=seed)
        self.flusher = CacheFlusher() if flush_cache else None

    def ops(self) -> KernelOps:
        return _OPS

    def _asarray(self, a: np.ndarray) -> np.ndarray:
        return np.asfortranarray(a)

    def _pre_rep(self) -> None:
        if self.flusher:
            self.flusher.flush()
