"""Wrapper of the hand-written Hopper SYMM (``csrc/symm.cu``).

Replaces ``src/repro/kernels/symm.py:symm_pallas``. The kernel is the
GEMM of ``csrc/sgemm.cuh`` with the symmetric operand read through copy
modes: each block cuts the contraction at its rows' diagonal band into
the segments :func:`symm_segments` names, so only the lower triangle of
S is ever read, through its strides. The tile and the contraction split
are chosen per call (:func:`symm_config`). Side R (B·S) is
``symm_cuda(s, b.mT).mT``: two views, no copy. Its plain version is
:func:`repro_torch.kernels.ref.symm`.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import torch

from . import _build
# config_to_dict is the GEMM's: a SYMM launch has the same knobs.
from .gemm import (SMS, GemmConfig, candidates, config_to_dict,  # noqa: F401
                   gemm_config, match_config, sm_count)

#: Launches of the CUDA kernel in this process.
launches = 0


def symm_config(m: int, n: int, sms: int = SMS) -> GemmConfig:
    """The launch for sym(S)·B with S m x m and B m x n: the GEMM's rule
    (:func:`repro_torch.kernels.gemm.gemm_config`) on the (m x m)·(m x n)
    product, since grid, slabs and inner loop are the GEMM's. The band's
    4-byte copies are BM of the m contraction steps and are charged
    nothing (PERF.md, section 6)."""
    return gemm_config(m, n, m, sms)


def config_from_dict(dims: Sequence[int], d: Mapping) -> Optional[GemmConfig]:
    """The launch a tuning-table entry (``{"tile", "split"}``) names for
    sym(S)·B at (m, n), or None unless it is one of the GEMM's candidates
    over the contraction m."""
    return match_config(candidates(int(dims[0])), d)


def symm_segments(row0: int, bm: int, k0: int,
                  k1: int) -> List[Tuple[str, int, int]]:
    """The segments (kind, start, end) of the contraction slice [k0, k1)
    of a block whose rows are [row0, row0 + bm), in the order the kernel
    accumulates them; empty ones are left out.

    ``"below"``: k < row0 <= i, reads S(i, k) as stored; ``"band"``:
    the rows' own columns, reads S(max(i, k), min(i, k)); ``"above"``:
    k >= row0 + bm > i, reads S(k, i) through transposed strides.
    """
    cuts = (("below", k0, min(k1, row0)),
            ("band", max(k0, row0), min(k1, row0 + bm)),
            ("above", max(k0, row0 + bm), k1))
    return [(kind, s, e) for kind, s, e in cuts if s < e]


def symm_cuda(s_lower: torch.Tensor, b: torch.Tensor,
              cfg: Optional[GemmConfig] = None) -> torch.Tensor:
    """sym(S)·B on the card under ``cfg`` (a tuned launch), else under
    :func:`symm_config`'s pick; operands already validated by
    ``ops.symm``."""
    if cfg is None:
        cfg = symm_config(b.shape[0], b.shape[1], sm_count(b.get_device()))
    return launch(s_lower, b, cfg)


def launch(s_lower: torch.Tensor, b: torch.Tensor,
           cfg: GemmConfig) -> torch.Tensor:
    """sym(S)·B on the card under the launch ``cfg``: the one place the
    kernel is launched and counted (timing scripts and tests call it with
    the configurations :func:`symm_config` did not pick)."""
    global launches
    device = b.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(s_lower, b, cfg)
    m, n = b.shape
    out = torch.empty((m, n), dtype=torch.float32, device=b.device)
    if out.numel() == 0:
        return out
    ws = (torch.empty((cfg.split, m, n), dtype=torch.float32, device=b.device)
          if cfg.split > 1 else None)
    rc = _build.library().repro_symm_f32(
        s_lower.data_ptr(), s_lower.stride(0), s_lower.stride(1),
        b.data_ptr(), b.stride(0), b.stride(1),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        m, n, cfg.config, cfg.split, cfg.kchunk, _build.stream(device))
    _build.check(rc, "symm")
    launches += 1
    return out
