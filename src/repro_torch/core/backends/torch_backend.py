"""The ``torch`` and ``cuda`` execution backends.

Counterpart of the reference package's ``core/backends/jax_backend.py``:

* ``torch`` (:class:`TorchBackend`) lowers every kernel kind to plain
  ATen calls — the counterpart of ``jax``;
* ``cuda`` (:class:`CudaBackend`) routes gemm/syrk/symm and the fused
  ``gemm+gemm`` chain through the hand-written kernels of
  :mod:`repro_torch.kernels.ops` — the counterpart of ``pallas``.

Both measure under the ``float32`` label, so both switch TF32 off: a TF32
product would be a different result under that label. The default device
is ``cuda``; without a card, constructing a backend without
``device="cpu"`` raises rather than quietly measuring the CPU.
Registration is the explicit call :func:`register_torch_backends`.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ...kernels import ops as kops
from ...kernels import ref
from ..fingerprint import HardwareFingerprint, device_label
from .base import (ExecutionBackend, KernelOps, register_backend,
                   registered_backends)


class TorchOps(KernelOps):
    """Plain ATen kernel vocabulary."""

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

    Advertises the fused ``gemm+gemm`` pattern (``chain_gemm``) unless
    ``REPRO_NO_FUSION`` is set, as the reference's ``pallas`` does.
    """

    def fused_kinds(self) -> frozenset:
        if os.environ.get("REPRO_NO_FUSION"):
            return frozenset()
        return frozenset({"gemm+gemm"})

    def gemm(self, a, b):
        return kops.gemm(a, b)

    def syrk(self, a):
        return kops.syrk(a)

    def symm(self, s, b):
        return kops.symm(s, b)

    def symm_r(self, b, s):
        # B·S with S symmetric: (S·Bᵀ)ᵀ via the side-L kernel.
        return kops.symm(s, b.mT).mT

    def tri2full(self, t):
        return kops.tri2full(t)

    def chain_gemm(self, a, b, c):
        return kops.chain_gemm(a, b, c)


class TorchBackend(ExecutionBackend):
    """Execute and time algorithms with plain ATen on one device."""

    name = "torch"
    default_dtype = "float32"
    dtypes = ("float32",)

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
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def ops(self) -> KernelOps:
        return TorchOps()

    def _asarray(self, a: np.ndarray) -> torch.Tensor:
        # Round to float32 on the host, exactly as numpy/JAX do, then move.
        return torch.from_numpy(a).to(torch.float32).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fingerprint(self) -> HardwareFingerprint:
        """What this backend's measurements are valid for."""
        return HardwareFingerprint(self.name, device_label(self.device),
                                   self.dtype)


class CudaBackend(TorchBackend):
    """The ``cuda`` registry entry: the hand-written kernels as a backend."""

    name = "cuda"

    def ops(self) -> KernelOps:
        return CudaOps()


def register_torch_backends() -> None:
    """Register ``torch`` and ``cuda`` (idempotent)."""
    known = registered_backends()
    for cls in (TorchBackend, CudaBackend):
        if cls.name not in known:
            register_backend(cls.name, cls)
