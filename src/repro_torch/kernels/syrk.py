"""Wrapper of the hand-written Hopper SYRK (``csrc/syrk.cu``).

Replaces ``src/repro/kernels/syrk.py:syrk_pallas``. The kernel is the
GEMM routine of ``csrc/sgemm.cuh`` on square tiles, launched over the
lower-triangular tiles only (:func:`syrk_blocks`), with A as both
operands. The tile and a contraction split are chosen per call
(:func:`syrk_config`); split slices are summed in slice order by a pass
that also writes the strict upper zeros, and a single slice stores them
itself, so the output is allocated with ``torch.empty`` and no zeroing
pass runs outside the kernel. Its plain version is
:func:`repro_torch.kernels.ref.syrk`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Iterator, List, Tuple

import numpy as np
import torch

from . import _build
from .gemm import (SMS, US_PER_MMAC, US_SPLIT, GemmConfig, candidates,
                   sm_count)

#: Launches of the CUDA kernel in this process.
launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tiles(m: int, bm: int) -> int:
    """Lower-triangular bm x bm tiles of an m x m output: mt(mt+1)/2."""
    mt = _cdiv(m, bm)
    return mt * (mt + 1) // 2


def syrk_candidates(k: int) -> List[GemmConfig]:
    """The GEMM's square tiles (128x128, 64x64), each with the contraction
    cut as :func:`repro_torch.kernels.gemm.candidates` cuts it."""
    return [c for c in candidates(k) if c.bm == c.bn]


def syrk_cost(m: int, cfg: GemmConfig, sms: int = SMS) -> float:
    """Modeled microseconds of ``cfg``: the GEMM's model
    (:func:`repro_torch.kernels.gemm.gemm_cost`) over the T·split blocks
    of the triangular grid instead of a rectangle's."""
    busiest = _cdiv(tiles(m, cfg.bm) * cfg.split, sms) * cfg.bm * cfg.bn * cfg.kchunk
    return (busiest * 1e-6 * US_PER_MMAC[cfg.config]
            + (US_SPLIT if cfg.split > 1 else 0.0))


@lru_cache(maxsize=4096)
def syrk_config(m: int, k: int, sms: int = SMS) -> GemmConfig:
    """The launch the wrapper makes for tril(A·Aᵀ), A m x k: the candidate
    of least :func:`syrk_cost`, ties to the larger tile, then to fewer
    slices."""
    return min(syrk_candidates(k),
               key=lambda c: (syrk_cost(m, c, sms), c.config, c.split))


def tile_of(t: int) -> Tuple[int, int]:
    """(bi, bj), bj <= bi, of lower-triangular tile t in row-major order,
    t = bi(bi+1)/2 + bj: the kernel's decode of its block index
    (``tri_decode`` in ``csrc/sgemm.cuh``), its float32 estimate
    included."""
    f32 = np.float32
    bi = int((np.sqrt(f32(8) * f32(t) + f32(1)) - f32(1)) * f32(0.5))
    while bi * (bi + 1) // 2 > t:
        bi -= 1
    while (bi + 1) * (bi + 2) // 2 <= t:
        bi += 1
    return bi, t - bi * (bi + 1) // 2


def syrk_blocks(m: int, k: int,
                cfg: GemmConfig) -> Iterator[Tuple[int, int, int, int]]:
    """(row0, col0, k0, k1) of every block of the launch, as the kernel
    derives them from its block index: the lower-triangular output tile
    [row0, row0 + bm) x [col0, col0 + bm) (clipped to m x m by the
    kernel's masks) over the contraction slice [k0, k1)."""
    for z in range(cfg.split):
        k0 = z * cfg.kchunk
        for t in range(tiles(m, cfg.bm)):
            bi, bj = tile_of(t)
            yield bi * cfg.bm, bj * cfg.bm, k0, min(k, k0 + cfg.kchunk)


def syrk_cuda(a: torch.Tensor) -> torch.Tensor:
    """tril(A·Aᵀ) on the card; ``a`` already validated by ``ops.syrk``."""
    m, k = a.shape
    return launch(a, syrk_config(m, k, sm_count(a.get_device())))


def launch(a: torch.Tensor, cfg: GemmConfig) -> torch.Tensor:
    """tril(A·Aᵀ) on the card under the launch ``cfg``: the one place the
    kernel is launched and counted (timing scripts and tests call it with
    the configurations :func:`syrk_config` did not pick)."""
    global launches
    device = a.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(a, cfg)
    m, k = a.shape
    out = torch.empty((m, m), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    ws = (torch.empty((cfg.split, m, m), dtype=torch.float32, device=a.device)
          if cfg.split > 1 else None)
    rc = _build.library().repro_syrk_f32(
        a.data_ptr(), a.stride(0), a.stride(1), out.data_ptr(),
        None if ws is None else ws.data_ptr(), m, k, cfg.config, cfg.split,
        cfg.kchunk, _build.stream(device))
    _build.check(rc, "syrk")
    launches += 1
    return out
