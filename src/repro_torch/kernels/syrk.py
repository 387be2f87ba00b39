"""Wrapper of the hand-written Hopper SYRK (``csrc/syrk.cu``).

Replaces ``src/repro/kernels/syrk.py:syrk_pallas``. The kernel launches
only the lower-triangular tiles and writes the strictly-upper zeros
itself, so the output is allocated with ``torch.empty`` and no zeroing
pass runs outside the kernel. Its plain version is
:func:`repro_torch.kernels.ref.syrk`.
"""

from __future__ import annotations

import torch

from . import _build

#: Launches of the CUDA kernel in this process.
launches = 0


def syrk_cuda(a: torch.Tensor) -> torch.Tensor:
    """tril(A·Aᵀ) on the card; ``a`` already validated by ``ops.syrk``."""
    global launches
    m, k = a.shape
    out = torch.empty((m, m), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(a.device):
        rc = lib.repro_syrk_f32(
            a.data_ptr(), a.stride(0), a.stride(1),
            out.data_ptr(), m, k, _build.stream(a.device))
    _build.check(rc, "syrk")
    launches += 1
    return out
