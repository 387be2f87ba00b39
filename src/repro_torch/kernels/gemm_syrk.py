"""Wrapper of the hand-written Hopper fused GEMM+SYRK (``csrc/gemm_syrk.cu``).

Replaces ``src/repro/kernels/chain_gemm.py:gemm_syrk_pallas``. The kernel
never writes M1 = A·B to device memory: one thread-block cluster per
l-chunk of M1 builds the chunk's 64-row pieces once, spread over its CTAs'
shared memory, and each CTA multiplies its share of the chunk's
lower-triangular tile pairs reading the pieces through distributed shared
memory (:func:`gemm_syrk_blocks`). The chunk width and the cluster size
are chosen per call (:func:`gemm_syrk_config`). The launch zeroes the
output (``cudaMemsetAsync``) before the kernel adds the chunks' partial
sums with float32 atomics, and the strict upper triangle stays zero.

The cluster's shared memory must hold the m x BL panel of M1. Beyond what
the narrowest launch holds (m above :func:`max_m`, 23,552 rows),
the wrapper does what the reference wrapper does above its VMEM bound:
``syrk(gemm(a, b))``, here the port's own gemm and syrk kernels, counted
as launches of those. Its plain version is
:func:`repro_torch.kernels.ref.gemm_syrk`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Iterator, List, Mapping, Optional, Sequence, Tuple

import torch

from . import _build
from . import gemm as _gemm
from . import syrk as _syrk
# The slab depth, ring stages and row padding of ``csrc/sgemm.cuh``.
from .gemm import BK, PAD, STAGES

#: Rows of a piece of M1 and side of an output tile.
BM = 64
#: Chunk widths compiled into ``csrc/gemm_syrk.cu`` (multiples of BK).
WIDTHS = (16, 32, 64)
#: The portable thread-block cluster size.
MAX_CLUSTER = 8
#: Dynamic shared memory a block may use on the H100 (227 KB), and the
#: least a CTA takes: more than half an SM's, so no two CTAs share one.
SMEM_BYTES = 232448
SPREAD_BYTES = 116 * 1024
#: Clusters of 1..8 CTAs resident at once at one CTA an SM:
#: ``cudaOccupancyMaxActiveClusters`` on the H100 SXM (132 SMs), which
#: packs clusters into its GPCs (PERF.md, section 6). On the card the
#: wrapper queries the card's own (:func:`active_clusters`).
ACTIVE_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)
#: Modeled time of a CTA (:func:`gemm_syrk_cost`): microseconds per
#: million multiply-adds of the piece build, by chunk width (``WIDTHS``
#: order), and of the pair products, and the microseconds each pair adds
#: (its staging copy, barrier and atomic epilogue). A least-squares fit to
#: 621 timings of every launch at the sweep's 27 shapes (``ab_bench.py
#: --sections gemm_syrk``, NVIDIA H100 80GB HBM3 at 700 W; PERF.md,
#: section 6). The GEMM's 64x64 rate alone picked a launch within 10 % of
#: the fastest at none of the 27.
US_PER_MMAC_PIECE = (26.193, 15.316, 10.701)
US_PER_MMAC_PAIR = 7.83
US_PER_PAIR = 0.57

#: Launches of the CUDA kernel in this process.
launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class GemmSyrkConfig:
    """One launch: l-chunks of ``bl`` columns, one cluster of ``cluster``
    CTAs per chunk."""

    bl: int
    cluster: int

    def chunks(self, l: int) -> int:
        return _cdiv(l, self.bl)

    def blocks(self, l: int) -> int:
        return self.chunks(l) * self.cluster

    def slots(self, m: int) -> int:
        """Pieces the busiest CTA owns."""
        return _cdiv(_cdiv(m, BM), self.cluster)

    def smem_bytes(self, m: int) -> int:
        """Dynamic shared memory of a CTA: the ring of the piece build, its
        pieces and three staging pieces (``csrc/gemm_syrk.cu``), at least
        :data:`SPREAD_BYTES`."""
        ring = STAGES * BK * ((BM + PAD) + (self.bl + PAD)) * 4
        return max(SPREAD_BYTES,
                   ring + (self.slots(m) + 3) * self.bl * (BM + PAD) * 4)

    def fits(self, m: int) -> bool:
        return self.smem_bytes(m) <= SMEM_BYTES

    @property
    def name(self) -> str:
        return f"bl{self.bl} c{self.cluster}"


CONFIGS = tuple(GemmSyrkConfig(bl, c) for bl in WIDTHS
                for c in range(1, MAX_CLUSTER + 1))


def max_m() -> int:
    """The largest m some launch holds: pieces of the narrowest chunk over
    the largest cluster."""
    cfg = GemmSyrkConfig(WIDTHS[0], MAX_CLUSTER)
    m = BM
    while cfg.fits(m + BM):
        m += BM
    return m


def pair_range(pairs: int, cluster: int, rank: int) -> Tuple[int, int]:
    """[t0, t1) of the pairs CTA ``rank`` multiplies."""
    return rank * pairs // cluster, (rank + 1) * pairs // cluster


def gemm_syrk_cost(m: int, k: int, l: int, cfg: GemmSyrkConfig,
                   active: Tuple[int, ...] = ACTIVE_CLUSTERS) -> float:
    """Modeled microseconds of ``cfg``: the busiest CTA's work, as
    ``gemm_cost`` and ``chain_cost`` model theirs, times the waves of
    clusters (``active[C - 1]`` resident at once). The busiest CTA builds
    ``slots`` 64 x bl pieces over k and multiplies ceil(pairs / C) 64 x 64
    pairs over bl, each at its fitted rate, plus a fixed cost a pair."""
    mt = _cdiv(m, BM)
    per_pair = _cdiv(mt * (mt + 1) // 2, cfg.cluster)
    per_cta = (cfg.slots(m) * BM * cfg.bl * _cdiv(k, BK) * BK * 1e-6
               * US_PER_MMAC_PIECE[WIDTHS.index(cfg.bl)]
               + per_pair * BM * BM * cfg.bl * 1e-6 * US_PER_MMAC_PAIR
               + per_pair * US_PER_PAIR)
    return _cdiv(cfg.chunks(l), active[cfg.cluster - 1]) * per_cta


def candidates(m: int) -> List[GemmSyrkConfig]:
    """Every launch whose pieces fit a CTA's shared memory."""
    return [c for c in CONFIGS if c.fits(m)]


def config_to_dict(cfg: GemmSyrkConfig) -> dict:
    """The launch as a tuning-table entry: ``{"bl", "cluster"}``."""
    return {"bl": cfg.bl, "cluster": cfg.cluster}


def config_from_dict(dims: Sequence[int], d: Mapping,
                     active: Tuple[int, ...] = ACTIVE_CLUSTERS
                     ) -> Optional[GemmSyrkConfig]:
    """The launch a tuning-table entry names for (m, k, l), or None
    unless it is one of :func:`candidates` at that m and a card holding
    ``active[C - 1]`` resident clusters of C can run a cluster of its
    size (other keys are ignored)."""
    try:
        bl, cluster = int(d["bl"]), int(d["cluster"])
    except (KeyError, TypeError, ValueError):
        return None
    for c in candidates(int(dims[0])):
        if c.bl == bl and c.cluster == cluster and active[cluster - 1] > 0:
            return c
    return None


@lru_cache(maxsize=4096)
def gemm_syrk_config(m: int, k: int, l: int,
                     active: Tuple[int, ...] = ACTIVE_CLUSTERS
                     ) -> Optional[GemmSyrkConfig]:
    """The launch for tril((A·B)(A·B)ᵀ), A m x k, B k x l, on a card
    holding ``active[C - 1]`` resident clusters of C: the candidate of
    least :func:`gemm_syrk_cost`, ties to the wider chunk, then to the
    smaller cluster; None where no launch holds the panel."""
    fit = candidates(m)
    if not fit:
        return None
    return min(fit, key=lambda c: (gemm_syrk_cost(m, k, l, c, active),
                                   -c.bl, c.cluster))


def gemm_syrk_blocks(m: int, k: int, l: int, cfg: GemmSyrkConfig) -> Iterator[
        Tuple[int, int, Tuple[int, ...], Tuple[Tuple[int, int], ...]]]:
    """(chunk, rank, pieces built, tile pairs multiplied) of every CTA of
    the launch, as the kernel derives them from its cluster rank: it
    builds the pieces M1[i·64:(i+1)·64, chunk·bl:(chunk+1)·bl] of row
    tiles i = rank, rank + C, ... over all of k, and multiplies the pairs
    (i, j <= i) of its range of the chunk's pairs in row-major order."""
    mt = _cdiv(m, BM)
    pairs = mt * (mt + 1) // 2
    for chunk in range(cfg.chunks(l)):
        for rank in range(cfg.cluster):
            t0, t1 = pair_range(pairs, cfg.cluster, rank)
            yield (chunk, rank, tuple(range(rank, mt, cfg.cluster)),
                   tuple(_syrk.tile_of(t) for t in range(t0, t1)))


def executed_flops(m: int, k: int, l: int, cfg: GemmSyrkConfig) -> int:
    """Flops the kernel executes under ``cfg``: a piece is 64 x bl over k
    in 16-deep slabs, a pair 64 x 64 over its chunk's columns in 16-deep
    slabs (padding included)."""
    flops = 0
    for chunk, _, pieces, pairs in gemm_syrk_blocks(m, k, l, cfg):
        width = min(l, (chunk + 1) * cfg.bl) - chunk * cfg.bl
        flops += 2 * len(pieces) * BM * cfg.bl * _cdiv(k, BK) * BK
        flops += 2 * len(pairs) * BM * BM * _cdiv(width, BK) * BK
    return flops


def gemm_syrk_cuda(a: torch.Tensor, b: torch.Tensor,
                   cfg: Optional[GemmSyrkConfig] = None) -> torch.Tensor:
    """tril((A·B)(A·B)ᵀ) on the card under ``cfg`` (a tuned launch), else
    under :func:`gemm_syrk_config`'s pick; operands already validated by
    ``ops.gemm_syrk``. Above :func:`max_m` rows, where no launch holds the
    panel, ``syrk(gemm(a, b))`` on the port's kernels."""
    if cfg is None:
        m, k = a.shape
        cfg = gemm_syrk_config(m, k, b.shape[1],
                               active_clusters(a.get_device()))
    if cfg is None:
        return _syrk.syrk_cuda(_gemm.gemm_cuda(a, b))
    return launch(a, b, cfg)


def launch(a: torch.Tensor, b: torch.Tensor,
           cfg: GemmSyrkConfig) -> torch.Tensor:
    """tril((A·B)(A·B)ᵀ) on the card under the launch ``cfg``: the one
    place the kernel is launched and counted (timing scripts and tests
    call it with the launches :func:`gemm_syrk_config` did not pick)."""
    global launches
    device = a.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(a, b, cfg)
    m, k = a.shape
    l = b.shape[1]
    out = torch.empty((m, m), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    rc = _build.library().repro_gemm_syrk_f32(
        a.data_ptr(), a.stride(0), a.stride(1),
        b.data_ptr(), b.stride(0), b.stride(1),
        out.data_ptr(), m, k, l, cfg.bl, cfg.cluster, _build.stream(device))
    _build.check(rc, "gemm_syrk")
    launches += 1
    return out


@lru_cache(maxsize=None)
def active_clusters(device: int) -> Tuple[int, ...]:
    """Resident clusters of 1..8 CTAs on CUDA device ``device``: the
    card's counterpart of :data:`ACTIVE_CLUSTERS` (every launch takes at
    least SPREAD_BYTES, so the count does not depend on the launch)."""
    with torch.cuda.device(device):
        return tuple(max_active_clusters(BM, GemmSyrkConfig(WIDTHS[0], c))
                     for c in range(1, MAX_CLUSTER + 1))


def max_active_clusters(m: int, cfg: GemmSyrkConfig) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the launch ``cfg`` for an m x
    m output, on the current device."""
    count = ctypes.c_int(0)
    _build.check(_build.library().repro_gemm_syrk_max_clusters(
        m, cfg.bl, cfg.cluster, ctypes.byref(count)), "gemm_syrk occupancy")
    return count.value
