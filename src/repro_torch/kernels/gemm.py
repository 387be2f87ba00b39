"""Wrapper of the hand-written Hopper GEMM (``csrc/gemm.cu``).

Replaces ``src/repro/kernels/gemm.py:gemm_pallas``. The kernel masks its
ragged edges and reads both operands through their strides, so the
wrapper neither pads, slices nor copies; it allocates the output and
launches on PyTorch's current stream. Its plain version is
:func:`repro_torch.kernels.ref.gemm`.
"""

from __future__ import annotations

import torch

from . import _build

#: Launches of the CUDA kernel in this process.
launches = 0


def gemm_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A·B on the card; operands already validated by ``ops.gemm``."""
    global launches
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(a.device):
        rc = lib.repro_gemm_f32(
            a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1),
            out.data_ptr(), m, n, k, _build.stream(a.device))
    _build.check(rc, "gemm")
    launches += 1
    return out
