"""Wrapper of the hand-written Hopper fused chain (``csrc/chain_gemm.cu``).

Replaces ``src/repro/kernels/chain_gemm.py:chain_gemm_pallas``. Block
(l-chunk p, row tile i) of the kernel builds the piece M1[i, p] of
M1 = A·B once on the GEMM routine of ``csrc/sgemm.cuh``, keeps it in
shared memory and multiplies it by C[p, :], so M1 never reaches device
memory and costs no extra flops (:func:`chain_blocks`). Shared memory per
block is fixed whatever the dims, so unlike the reference wrapper there
is no memory bound above which it falls back to two GEMMs. The piece
(BM x BL) is chosen per call (:func:`chain_config`); the l-chunks'
partial sums are added with float32 atomics into a zeroed output. A 3-D
batch is one launch, its instances on the grid's z axis
(:func:`chain_batch_blocks`). Its plain version is
:func:`repro_torch.kernels.ref.chain_gemm`.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Iterator, Mapping, Optional, Sequence, Tuple

import torch

from . import _build
from .gemm import (PAD, SMS, US_PER_MMAC, grid_yz, sm_count, strided,
                   tile_smem_bytes)

#: Pieces (BM rows, BL l-columns) compiled into ``csrc/chain_gemm.cu``,
#: largest first; the index is the ``config`` argument of
#: ``repro_chain_gemm_f32``. The second product's output tiles are BM x BL.
TILES: Tuple[Tuple[int, int], ...] = ((128, 128), (128, 64), (64, 64))

#: Launches of the CUDA kernel in this process.
launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class ChainConfig:
    """One launch of the chain: pieces ``TILES[config]`` = (bm, bl)."""

    config: int
    bm: int
    bl: int

    def chunks(self, l: int) -> int:
        return _cdiv(l, self.bl)

    def blocks(self, m: int, l: int) -> int:
        return _cdiv(m, self.bm) * self.chunks(l)

    @property
    def name(self) -> str:
        return f"{self.bm}x{self.bl}"

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block: the GEMM routine's ring plus
        the parked piece (``piece_bytes`` in ``csrc/chain_gemm.cu``)."""
        return tile_smem_bytes(self.bm, self.bl) + self.bl * (self.bm + PAD) * 4


CONFIGS = tuple(ChainConfig(i, bm, bl) for i, (bm, bl) in enumerate(TILES))


def config_to_dict(cfg: ChainConfig) -> dict:
    """The launch as a tuning-table entry: ``{"piece"}``."""
    return {"piece": cfg.config}


def config_from_dict(dims: Sequence[int],
                     d: Mapping) -> Optional[ChainConfig]:
    """The launch a tuning-table entry names, or None unless its piece is
    one of :data:`CONFIGS` (other keys are ignored)."""
    try:
        piece = int(d["piece"])
    except (KeyError, TypeError, ValueError):
        return None
    return CONFIGS[piece] if 0 <= piece < len(CONFIGS) else None


def chain_cost(m: int, k: int, l: int, n: int, cfg: ChainConfig,
               sms: int = SMS, batch: int = 1) -> float:
    """Modeled microseconds of ``cfg``: the busiest SM's multiply-adds
    over both products (its share of the grid in whole blocks; each block
    builds a bm x bl piece over k and multiplies it by bl x n, in output
    tiles of bl columns) at the tile's rate in the GEMM
    (:data:`repro_torch.kernels.gemm.US_PER_MMAC`), over ``batch``
    instances' blocks. The l-chunks' reduction is charged nothing:
    wherever l > 128 every piece has more than one chunk, so a term for it
    would move no pick."""
    per_block = cfg.bm * cfg.bl * (k + _cdiv(n, cfg.bl) * cfg.bl)
    busiest = _cdiv(cfg.blocks(m, l) * batch, sms) * per_block
    return busiest * 1e-6 * US_PER_MMAC[cfg.config]


@lru_cache(maxsize=4096)
def chain_config(m: int, k: int, l: int, n: int, sms: int = SMS,
                 batch: int = 1) -> ChainConfig:
    """The launch the wrapper makes for ``batch`` chains
    (m x k)·(k x l)·(l x n): the piece of least :func:`chain_cost`, ties
    to the larger piece."""
    return min(CONFIGS, key=lambda c: (chain_cost(m, k, l, n, c, sms, batch),
                                       c.config))


def chain_grid(m: int, l: int, cfg: ChainConfig,
               batch: int = 1) -> Tuple[int, int, int]:
    """The launch's grid (x, y, z): l-chunks, row tiles, and the batch's
    instances up to :data:`~repro_torch.kernels.gemm.MAX_GRID_YZ`."""
    return cfg.chunks(l), _cdiv(m, cfg.bm), grid_yz(batch)


def chain_batch_blocks(m: int, l: int, cfg: ChainConfig, batch: int
                       ) -> Iterator[Tuple[int, int, int, int]]:
    """(instance, row0, l0, l1) of every pass of every block of a batched
    launch, as the kernel derives them: block z takes instances z,
    z + gridDim.z, ..., each the piece M1[row0:row0 + bm, l0:l1] of that
    instance (rows clipped to m by the kernel's masks), built over all of
    k and multiplied by C[l0:l1, :] in output tiles of bl columns."""
    gx, gy, gz = chain_grid(m, l, cfg, batch)
    for _, inst in strided(batch, gz):
        for y in range(gy):
            for x in range(gx):
                yield (inst, y * cfg.bm, x * cfg.bl,
                       min(l, (x + 1) * cfg.bl))


def chain_blocks(m: int, l: int,
                 cfg: ChainConfig) -> Iterator[Tuple[int, int, int]]:
    """(row0, l0, l1) of every block of a launch of one chain
    (:func:`chain_batch_blocks` at batch 1)."""
    for _, *block in chain_batch_blocks(m, l, cfg, 1):
        yield tuple(block)


def chain_gemm_cuda(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    cfg: Optional[ChainConfig] = None) -> torch.Tensor:
    """(A·B)·C on the card under ``cfg`` (a tuned launch), else under
    :func:`chain_config`'s pick; operands already validated by
    ``ops.chain_gemm``."""
    if cfg is None:
        m, k = a.shape[-2:]
        l, n = c.shape[-2:]
        cfg = chain_config(m, k, l, n, sm_count(a.get_device()),
                           a.shape[0] if a.dim() == 3 else 1)
    return launch(a, b, c, cfg)


def launch(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           cfg: ChainConfig) -> torch.Tensor:
    """(A·B)·C on the card under the launch ``cfg``, for matrices or 3-D
    batches of them (one launch): the one place the kernel is launched
    and counted (timing scripts and tests call it with the pieces
    :func:`chain_config` did not pick)."""
    global launches
    device = a.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(a, b, c, cfg)
    batched = a.dim() == 3
    batch = a.shape[0] if batched else 1
    m, k = a.shape[-2:]
    l, n = c.shape[-2:]
    out = torch.empty((batch, m, n) if batched else (m, n),
                      dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    rc = _build.library().repro_chain_gemm_f32(
        *_build.matrix_args(a, b, c), out.data_ptr(), batch,
        m, k, l, n, cfg.config, _build.stream(device))
    _build.check(rc, "chain_gemm")
    launches += 1
    return out
