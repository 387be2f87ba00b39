"""Wrapper of the hand-written Hopper SYMM (``csrc/symm.cu``).

Replaces ``src/repro/kernels/symm.py:symm_pallas``. The kernel reads only
the lower triangle of S, through its strides. Side R (B·S) is
``symm_cuda(s, b.mT).mT``: two views, no copy. Its plain version is
:func:`repro_torch.kernels.ref.symm`.
"""

from __future__ import annotations

import torch

from . import _build

#: Launches of the CUDA kernel in this process.
launches = 0


def symm_cuda(s_lower: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sym(S)·B on the card; operands already validated by ``ops.symm``."""
    global launches
    m = s_lower.shape[0]
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=b.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(b.device):
        rc = lib.repro_symm_f32(
            s_lower.data_ptr(), s_lower.stride(0), s_lower.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1),
            out.data_ptr(), m, n, _build.stream(b.device))
    _build.check(rc, "symm")
    launches += 1
    return out
