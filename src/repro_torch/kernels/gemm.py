"""Wrapper of the hand-written Hopper GEMM (``csrc/gemm.cu``).

Replaces ``src/repro/kernels/gemm.py:gemm_pallas``. The kernel masks its
ragged edges and reads both operands through their strides, so the
wrapper neither pads, slices nor copies; it picks the tile shape and the
contraction split per call (:func:`gemm_config`), allocates the output
(and, for a split, the workspace the slices are summed from) and launches
on PyTorch's current stream. Its plain version is
:func:`repro_torch.kernels.ref.gemm`.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Iterator, List, Mapping, Optional, Sequence, Tuple

import torch

from . import _build

#: Block tiles (rows, columns) compiled into ``csrc/gemm.cu``, largest
#: first; the index is the ``config`` argument of ``repro_gemm_f32``.
TILES: Tuple[Tuple[int, int], ...] = ((128, 128), (128, 64), (64, 64))
#: Contraction slab depth; every split slice is a multiple of it. Slabs
#: in the cp.async ring, and the floats each slab row is padded by
#: (``csrc/sgemm.cuh``).
BK = 16
STAGES, PAD = 3, 4
#: Shallowest slice a split makes, in contraction steps, and the most
#: slices: the range of splits timed on the card (PERF.md, section 6).
MIN_SLICE = 96
MAX_SPLIT = 4
#: Streaming multiprocessors of the H100 SXM; the wrapper reads the card's.
SMS = 132
#: Modeled time of a launch (:func:`gemm_cost`): microseconds per million
#: multiply-adds on the busiest SM, by tile (``TILES`` order), and the
#: microseconds a split's workspace pass adds. A least-squares fit to 324
#: timings of every tile x split 1-4 at the sweep's 27 shapes
#: (``ab_bench.py``, NVIDIA H100 80GB HBM3 at 700 W; PERF.md, section 6).
US_PER_MMAC = (6.63, 7.57, 9.21)
US_SPLIT = 7.02

#: Launches of the CUDA kernel in this process.
launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class GemmConfig:
    """One launch of the GEMM: tile ``TILES[config]`` = (bm, bn), and the
    contraction cut into ``split`` slices of ``kchunk``."""

    config: int
    bm: int
    bn: int
    split: int
    kchunk: int

    def blocks(self, m: int, n: int) -> int:
        return _cdiv(m, self.bm) * _cdiv(n, self.bn) * self.split

    @property
    def name(self) -> str:
        split = f" split {self.split}x{self.kchunk}" if self.split > 1 else ""
        return f"{self.bm}x{self.bn}{split}"

    @property
    def smem_bytes(self) -> int:
        return tile_smem_bytes(self.bm, self.bn)


def tile_smem_bytes(bm: int, bn: int) -> int:
    """Dynamic shared memory of a block of tile bm x bn: the ring of A and
    B slabs (``Tile::smem_bytes`` in ``csrc/sgemm.cuh``)."""
    return STAGES * BK * ((bm + PAD) + (bn + PAD)) * 4


def with_split(config: int, k: int, split: int) -> GemmConfig:
    """Tile ``config`` with the contraction cut into at most ``split``
    slices, each a multiple of :data:`BK` and none empty."""
    bm, bn = TILES[config]
    kchunk = _cdiv(_cdiv(max(k, 1), max(split, 1)), BK) * BK
    return GemmConfig(config, bm, bn, max(1, _cdiv(k, kchunk)), kchunk)


def candidates(k: int) -> List[GemmConfig]:
    """Every tile, each with the contraction cut into 1 to
    :data:`MAX_SPLIT` slices at least :data:`MIN_SLICE` deep."""
    most = max(1, min(MAX_SPLIT, k // MIN_SLICE))
    return [with_split(c, k, s) for c in range(len(TILES))
            for s in range(1, most + 1)]


def config_to_dict(cfg: GemmConfig) -> dict:
    """The launch as a tuning-table entry: ``{"tile", "split"}``."""
    return {"tile": cfg.config, "split": cfg.split}


def match_config(cands: Sequence[GemmConfig],
                 d: Mapping) -> Optional[GemmConfig]:
    """The candidate a ``{"tile", "split"}`` entry names, or None for an
    entry that names none of them (other keys are ignored)."""
    try:
        tile, split = int(d["tile"]), int(d["split"])
    except (KeyError, TypeError, ValueError):
        return None
    for c in cands:
        if c.config == tile and c.split == split:
            return c
    return None


def config_from_dict(dims: Sequence[int], d: Mapping) -> Optional[GemmConfig]:
    """The launch a tuning-table entry names for an (m, n, k) product, or
    None unless it is one of :func:`candidates` at that k."""
    return match_config(candidates(int(dims[2])), d)


def gemm_cost(m: int, n: int, cfg: GemmConfig, sms: int = SMS) -> float:
    """Modeled microseconds of ``cfg`` for an m x n output: the busiest
    SM's multiply-adds (its share of the grid, rounded up to whole blocks)
    at its tile's rate, plus the split's workspace pass."""
    busiest = _cdiv(cfg.blocks(m, n), sms) * cfg.bm * cfg.bn * cfg.kchunk
    return (busiest * 1e-6 * US_PER_MMAC[cfg.config]
            + (US_SPLIT if cfg.split > 1 else 0.0))


@lru_cache(maxsize=4096)
def gemm_config(m: int, n: int, k: int, sms: int = SMS) -> GemmConfig:
    """The launch the wrapper makes for an (m x k)·(k x n) product: the
    candidate of least :func:`gemm_cost`, ties to the larger tile, then
    to fewer slices."""
    return min(candidates(k),
               key=lambda c: (gemm_cost(m, n, c, sms), c.config, c.split))


def gemm_blocks(m: int, n: int, k: int,
                cfg: GemmConfig) -> Iterator[Tuple[int, int, int, int]]:
    """(row0, col0, k0, k1) of every block of the launch, as the kernel
    derives them from its block index: the output tile
    [row0, row0 + bm) x [col0, col0 + bn) (clipped to m x n by the
    kernel's masks) over the contraction slice [k0, k1)."""
    for z in range(cfg.split):
        k0 = z * cfg.kchunk
        k1 = min(k, k0 + cfg.kchunk)
        for y in range(_cdiv(m, cfg.bm)):
            for x in range(_cdiv(n, cfg.bn)):
                yield y * cfg.bm, x * cfg.bn, k0, k1


@lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """Streaming multiprocessors of CUDA device ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def gemm_cuda(a: torch.Tensor, b: torch.Tensor,
              cfg: Optional[GemmConfig] = None) -> torch.Tensor:
    """C = A·B on the card under ``cfg`` (a tuned launch), else under
    :func:`gemm_config`'s pick; operands already validated by
    ``ops.gemm``."""
    if cfg is None:
        m, k = a.shape
        cfg = gemm_config(m, b.shape[1], k, sm_count(a.get_device()))
    return launch(a, b, cfg)


def launch(a: torch.Tensor, b: torch.Tensor, cfg: GemmConfig) -> torch.Tensor:
    """C = A·B on the card under the launch ``cfg``: the one place the
    kernel is launched and counted (timing scripts call it with the
    configurations :func:`gemm_config` did not pick)."""
    global launches
    device = a.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(a, b, cfg)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    ws = (torch.empty((cfg.split, m, n), dtype=torch.float32, device=a.device)
          if cfg.split > 1 else None)
    rc = _build.library().repro_gemm_f32(
        a.data_ptr(), a.stride(0), a.stride(1),
        b.data_ptr(), b.stride(0), b.stride(1),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        m, n, k, cfg.config, cfg.split, cfg.kchunk, _build.stream(device))
    _build.check(rc, "gemm")
    launches += 1
    return out
