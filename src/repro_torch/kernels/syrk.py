"""Wrapper of the hand-written Hopper SYRK (``csrc/syrk.cu``).

Replaces ``src/repro/kernels/syrk.py:syrk_pallas``. The kernel is the
GEMM routine of ``csrc/sgemm.cuh`` on square tiles, launched over the
lower-triangular tiles only (:func:`syrk_blocks`), with A as both
operands. The tile and a contraction split are chosen per call
(:func:`syrk_config`); split slices are summed in slice order by a pass
that also writes the strict upper zeros, and a single slice stores them
itself, so the output is allocated with ``torch.empty`` and no zeroing
pass runs outside the kernel. A 3-D batch is one launch, its instances on
the grid's y axis beside the split (:func:`syrk_batch_blocks`). Its plain
version is :func:`repro_torch.kernels.ref.syrk`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
# config_to_dict is the GEMM's: a SYRK launch has the same knobs.
from .gemm import (SMS, US_PER_MMAC, US_SPLIT, GemmConfig,  # noqa: F401
                   candidates, config_to_dict, grid_yz,
                   match_config, sm_count, strided)

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


def config_from_dict(dims: Sequence[int], d: Mapping) -> Optional[GemmConfig]:
    """The launch a tuning-table entry (``{"tile", "split"}``, as
    :func:`repro_torch.kernels.gemm.config_to_dict` writes it) names for
    an (m, k) SYRK, or None unless it is one of :func:`syrk_candidates`
    at that k."""
    return match_config(syrk_candidates(int(dims[1])), d)


def syrk_cost(m: int, cfg: GemmConfig, sms: int = SMS,
              batch: int = 1) -> float:
    """Modeled microseconds of ``cfg`` for ``batch`` instances: the GEMM's
    model (:func:`repro_torch.kernels.gemm.gemm_cost`) over the
    T·split·batch blocks of the triangular grid instead of a rectangle's."""
    busiest = (_cdiv(tiles(m, cfg.bm) * cfg.split * batch, sms)
               * cfg.bm * cfg.bn * cfg.kchunk)
    return (busiest * 1e-6 * US_PER_MMAC[cfg.config]
            + (US_SPLIT if cfg.split > 1 else 0.0))


@lru_cache(maxsize=4096)
def syrk_config(m: int, k: int, sms: int = SMS,
                batch: int = 1) -> GemmConfig:
    """The launch the wrapper makes for ``batch`` products tril(A·Aᵀ), A
    m x k: the candidate of least :func:`syrk_cost`, ties to the larger
    tile, then to fewer slices."""
    return min(syrk_candidates(k),
               key=lambda c: (syrk_cost(m, c, sms, batch), c.config, c.split))


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


def syrk_grid(m: int, cfg: GemmConfig, batch: int = 1) -> Tuple[int, int]:
    """The launch's grid (x, y): the T lower-triangular tiles, and the
    batch·split (instance, slice) pairs up to
    :data:`~repro_torch.kernels.gemm.MAX_GRID_YZ`."""
    return tiles(m, cfg.bm), grid_yz(batch * cfg.split)


def syrk_batch_blocks(m: int, k: int, cfg: GemmConfig, batch: int
                      ) -> Iterator[Tuple[int, int, int, int, int]]:
    """(instance, row0, col0, k0, k1) of every pass of every block of a
    batched launch, as the kernel derives them: block y takes the pairs
    u = y, y + gridDim.y, ... of u = instance·split + slice, each the
    lower-triangular output tile [row0, row0 + bm) x [col0, col0 + bm)
    (clipped to m x m by the kernel's masks) of block x over the
    contraction slice [k0, k1)."""
    gx, gy = syrk_grid(m, cfg, batch)
    for _, u in strided(batch * cfg.split, gy):
        k0 = u % cfg.split * cfg.kchunk
        for t in range(gx):
            bi, bj = tile_of(t)
            yield (u // cfg.split, bi * cfg.bm, bj * cfg.bm, k0,
                   min(k, k0 + cfg.kchunk))


def syrk_blocks(m: int, k: int,
                cfg: GemmConfig) -> Iterator[Tuple[int, int, int, int]]:
    """(row0, col0, k0, k1) of every block of a launch of one product
    (:func:`syrk_batch_blocks` at batch 1)."""
    for _, *block in syrk_batch_blocks(m, k, cfg, 1):
        yield tuple(block)


def syrk_cuda(a: torch.Tensor,
              cfg: Optional[GemmConfig] = None) -> torch.Tensor:
    """tril(A·Aᵀ) on the card under ``cfg`` (a tuned launch), else under
    :func:`syrk_config`'s pick; ``a`` already validated by ``ops.syrk``."""
    if cfg is None:
        m, k = a.shape[-2:]
        cfg = syrk_config(m, k, sm_count(a.get_device()),
                          a.shape[0] if a.dim() == 3 else 1)
    return launch(a, cfg)


def launch(a: torch.Tensor, cfg: GemmConfig) -> torch.Tensor:
    """tril(A·Aᵀ) on the card under the launch ``cfg``, for a matrix or a
    3-D batch of them (one launch): the one place the kernel is launched
    and counted (timing scripts and tests call it with the configurations
    :func:`syrk_config` did not pick)."""
    global launches
    device = a.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(a, cfg)
    batched = a.dim() == 3
    batch = a.shape[0] if batched else 1
    m, k = a.shape[-2:]
    out = torch.empty((batch, m, m) if batched else (m, m),
                      dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    ws = (torch.empty((batch, cfg.split, m, m), dtype=torch.float32,
                      device=a.device) if cfg.split > 1 else None)
    rc = _build.library().repro_syrk_f32(
        *_build.matrix_args(a), out.data_ptr(),
        None if ws is None else ws.data_ptr(), batch, m, k, cfg.config,
        cfg.split, cfg.kchunk, _build.stream(device))
    _build.check(rc, "syrk")
    launches += 1
    return out
