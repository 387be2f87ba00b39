"""Wrapper of the hand-written Hopper fused GEMM+SYRK (``csrc/gemm_syrk.cu``).

Replaces ``src/repro/kernels/chain_gemm.py:gemm_syrk_pallas``. The kernel
never writes M1 = A·B to device memory: each block builds the 64x64
pieces of M1 it needs in shared memory, a fixed 35 KB per block whatever
the dims, so unlike the reference wrapper there is no memory bound above
which it falls back to ``syrk(gemm(a, b))``. The launch zeroes the output
(``cudaMemsetAsync``) before the kernel adds its partial sums, and the
strict upper triangle stays zero. Its plain version is
:func:`repro_torch.kernels.ref.gemm_syrk`.
"""

from __future__ import annotations

import torch

from . import _build

#: Launches of the CUDA kernel in this process.
launches = 0


def gemm_syrk_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """tril((A·B)(A·B)ᵀ) on the card; operands already validated by
    ``ops.gemm_syrk``."""
    global launches
    m, k = a.shape
    l = b.shape[1]
    out = torch.empty((m, m), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(a.device):
        rc = lib.repro_gemm_syrk_f32(
            a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1),
            out.data_ptr(), m, k, l, _build.stream(a.device))
    _build.check(rc, "gemm_syrk")
    launches += 1
    return out
