"""Wrapper of the hand-written Hopper fused chain (``csrc/chain_gemm.cu``).

Replaces ``src/repro/kernels/chain_gemm.py:chain_gemm_pallas``. The
kernel keeps every piece of M1 = A·B in shared memory and needs a fixed
17 KB per block whatever the dims, so unlike the reference wrapper there
is no memory bound above which it falls back to two GEMMs. The launch
zeroes the output (``cudaMemsetAsync``) before the kernel adds its
partial sums. Its plain version is :func:`repro_torch.kernels.ref.chain_gemm`.
"""

from __future__ import annotations

import torch

from . import _build

#: Launches of the CUDA kernel in this process.
launches = 0


def chain_gemm_cuda(a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """(A·B)·C on the card; operands already validated by
    ``ops.chain_gemm``."""
    global launches
    m, k = a.shape
    l, n = c.shape
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(a.device):
        rc = lib.repro_chain_gemm_f32(
            a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1),
            c.data_ptr(), c.stride(0), c.stride(1),
            out.data_ptr(), m, k, l, n, _build.stream(a.device))
    _build.check(rc, "chain_gemm")
    launches += 1
    return out
