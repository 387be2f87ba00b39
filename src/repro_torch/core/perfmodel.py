"""Kernel performance profiles — the paper's missing discriminant.

The port's counterpart of the reference package's ``core/perfmodel.py``.
The paper's central finding is that FLOP count alone misleads because
kernel *efficiency* is a shape-dependent, kernel-dependent function
(paper Fig. 1), and that most anomalies are predictable from per-kernel
performance profiles benchmarked in isolation (Experiment 3, Tables 1–2:
92 % / 75 % recall).

A :class:`KernelProfile` maps a
:class:`~repro_torch.core.flops.KernelCall` to a predicted execution time,
and the ``perfmodel`` discriminant (:mod:`repro_torch.core.discriminants`)
ranks algorithms by ``Σ predicted call time`` — the paper's additive
kernel-sequence model.

Profile families:

* :class:`AnalyticalHopperProfile` — the port's device: the modeled time
  of the launch the hand-written CUDA kernel's wrapper makes on an
  NVIDIA H100 (:mod:`repro_torch.kernels.gemm` and its siblings), plus
  the host's work per call. The default analytical model of the port's
  discriminants.
* :class:`AnalyticalTPUProfile` — the reference's closed-form TPU v5e
  model (MXU tile quantization, HBM roofline, per-call overhead), kept as
  a copy so the two packages can be handed the same model and compared.
* :class:`RooflineProfile` — ``max(flops / peak, bytes / bandwidth)``.
* :class:`TableProfile` — exact benchmarked times keyed by (kind, dims);
  with log-space nearest-neighbour fallback for unseen shapes. This is
  the paper's "benchmarked performance profile", and is what Experiment 3
  consumes.
* :class:`HybridProfile` — the table where it has data, an analytical
  model elsewhere.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, Optional, Tuple

import torch

from ..kernels import gemm as _gemm
from ..kernels import symm as _symm
from ..kernels import syrk as _syrk
from .flops import KernelCall


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants for one accelerator chip."""

    name: str
    peak_flops: float        # FLOP/s at the working dtype
    hbm_bw: float            # bytes/s
    link_bw: float           # bytes/s per ICI link (for the 3-term model)
    vmem_bytes: int
    mxu_dim: int = 128       # systolic array edge
    kernel_overhead_s: float = 2e-6   # dispatch latency per kernel call


# TPU v5e, bf16 — constants given by the assignment.
TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    link_bw=50e9,
    vmem_bytes=128 * 1024 * 1024,
)

# A host CPU — rough constants for sanity checks only; the CPU path
# should prefer measured TableProfiles.
HOST_CPU = HardwareSpec(
    name="host_cpu",
    peak_flops=1.0e11,
    hbm_bw=3.0e10,
    link_bw=1e9,
    vmem_bytes=32 * 1024 * 1024,
    mxu_dim=16,
    kernel_overhead_s=5e-6,
)


# NVIDIA H100 SXM5, float32 — NVIDIA H100 Tensor Core GPU data sheet:
# 67 TFLOP/s FP32 outside the tensor cores (the sweep kernels' float32
# products run on the CUDA cores), 3.35 TB/s HBM3, NVLink 4 at 900 GB/s
# over 18 links; 228 KB of shared memory per SM (the kernels' on-chip
# scratch); 128 is the edge of the kernels' largest block tile. The
# per-call overhead is what one kernel call costs beyond the launch model
# as ``ExecutionBackend.benchmark_call`` times it on a card (one replay of
# the call's captured CUDA graph, the synchronise, the clock reads): the
# median of (calibrated gemm time - the launch model's time) over the 27
# gemm calls of the paper-scale grids (dims 400, 800, 1200) that
# ``chip_smoke.py`` phase 8 calibrates, 12.2 us on an NVIDIA H100 80GB
# HBM3 at a 700 W power limit (PERF.md, section 6; 48.1 us while each
# call was timed as the eager walk).
H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops=67e12,
    hbm_bw=3.35e12,
    link_bw=50e9,
    vmem_bytes=228 * 1024,
    mxu_dim=128,
    kernel_overhead_s=1.22e-5,
)


def _ceil_to(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


class KernelProfile:
    """Interface: predicted seconds for one kernel call."""

    def time(self, call: KernelCall, dtype_bytes: int = 8) -> float:
        raise NotImplementedError

    def efficiency(self, call: KernelCall, dtype_bytes: int = 8) -> float:
        """Fraction of peak achieved — the paper's Fig. 1 quantity."""
        t = self.time(call, dtype_bytes)
        if t <= 0 or call.flops == 0:
            return 0.0
        return min(1.0, call.flops / (t * self.peak()))

    def peak(self) -> float:
        raise NotImplementedError


class AnalyticalTPUProfile(KernelProfile):
    """Closed-form TPU model: MXU block quantization × HBM roofline.

    The MXU is a ``q×q`` systolic array (q=128 on v5e); work is charged in
    whole q³ blocks, so a GEMM with m=129 pays for m=256 — the abrupt
    efficiency cliffs of the paper's Fig. 1, TPU edition. SYRK computes only
    the lower-triangular block grid (T(mt) = mt(mt+1)/2 blocks instead of
    mt²), and SYMM halves the HBM traffic of the symmetric operand — the
    same FLOPs/efficiency asymmetries the paper measures on MKL.
    """

    def __init__(self, hw: HardwareSpec = TPU_V5E):
        self.hw = hw

    def peak(self) -> float:
        return self.hw.peak_flops

    def _gemm_compute(self, m: int, n: int, k: int) -> float:
        q = self.hw.mxu_dim
        mt, nt, kt = (_ceil_to(m, q) // q, _ceil_to(n, q) // q,
                      _ceil_to(k, q) // q)
        return 2.0 * mt * nt * kt * q ** 3 / self.hw.peak_flops

    def time(self, call: KernelCall, dtype_bytes: int = 2) -> float:
        hw = self.hw
        mem = call.bytes_moved * dtype_bytes / hw.hbm_bw
        if call.kind == "gemm":
            m, n, k = call.dims
            comp = self._gemm_compute(m, n, k)
        elif call.kind == "syrk":
            m, k = call.dims
            q = hw.mxu_dim
            mt = _ceil_to(m, q) // q
            kt = _ceil_to(k, q) // q
            blocks = mt * (mt + 1) // 2
            comp = 2.0 * blocks * kt * q ** 3 / hw.peak_flops
        elif call.kind == "symm":
            m, n = call.dims
            comp = self._gemm_compute(m, n, m)
        elif call.kind == "tri2full":
            comp = 0.0
        else:
            raise ValueError(call.kind)
        return max(comp, mem) + hw.kernel_overhead_s


class AnalyticalHopperProfile(KernelProfile):
    """The port's kernels on an H100: each call costs the modeled time of
    the launch its wrapper makes, plus the host's work per call.

    The launch models are the ones the wrappers pick launches by, fitted
    on the card (:mod:`repro_torch.kernels.gemm`): the busiest SM's
    multiply-adds, rounded up to whole blocks over the SMs, at its tile's
    rate, plus a contraction split's workspace pass.

    * ``gemm`` (m, n, k): ``gemm_cost`` of ``gemm_config(m, n, k)``;
    * ``syrk`` (m, k): ``syrk_cost`` of ``syrk_config(m, k)`` (the same
      model over the lower-triangular tiles only);
    * ``symm`` (m, n): ``gemm_cost`` of ``symm_config(m, n)`` (the GEMM's
      grid on the (m x m)·(m x n) product);
    * ``tri2full`` (m,): its copy's bytes at the HBM rate.

    Every call adds ``hw.kernel_overhead_s``. The rates were fitted at
    dims 400–1200 only; below that the host's work dominates and above it
    the model is extrapolated. Because the wrapper admits a 3- and a 4-way
    contraction split only from 288 and 384 on (k; symm's m), the modeled
    time can drop (by up to ~11 %) where the contraction crosses those
    values; it never decreases along another dim. ``sms`` defaults to the card's SM
    count where a card is present, else to the H100 SXM's 132.
    """

    def __init__(self, hw: HardwareSpec = H100_SXM,
                 sms: Optional[int] = None):
        self.hw = hw
        if sms is None:
            sms = (_gemm.sm_count(torch.cuda.current_device())
                   if torch.cuda.is_available() else _gemm.SMS)
        self.sms = sms

    def peak(self) -> float:
        return self.hw.peak_flops

    def launch_time(self, call: KernelCall, dtype_bytes: int = 4) -> float:
        """Modeled device seconds of the launch alone (no host work)."""
        if call.kind == "gemm":
            m, n, k = call.dims
            us = _gemm.gemm_cost(m, n, _gemm.gemm_config(m, n, k, self.sms),
                                 self.sms)
        elif call.kind == "syrk":
            m, k = call.dims
            us = _syrk.syrk_cost(m, _syrk.syrk_config(m, k, self.sms),
                                 self.sms)
        elif call.kind == "symm":
            m, n = call.dims
            us = _gemm.gemm_cost(m, n, _symm.symm_config(m, n, self.sms),
                                 self.sms)
        elif call.kind == "tri2full":
            return call.bytes_moved * dtype_bytes / self.hw.hbm_bw
        else:
            raise ValueError(call.kind)
        return us * 1e-6

    def time(self, call: KernelCall, dtype_bytes: int = 4) -> float:
        return self.launch_time(call, dtype_bytes) + self.hw.kernel_overhead_s


class RooflineProfile(KernelProfile):
    """Pure roofline: ``max(flops / peak, bytes·dtype / bandwidth)``.

    The minimal memory-traffic-aware model, and deliberately *simpler*
    than :class:`AnalyticalTPUProfile`: no MXU tile quantization and no
    per-call dispatch overhead, so the two analytical models disagree
    exactly where quantization cliffs (a 129-row GEMM paying for 256)
    dominate raw traffic. What it does see that FLOPs cannot: the
    zero-FLOP TRI2FULL copy costs ``m²`` bytes of traffic, and SYRK's
    triangular output halves its write traffic — the asymmetries behind
    the paper's anomalies. Backs the ``roofline`` discriminant
    (:mod:`repro_torch.core.discriminants`).
    """

    def __init__(self, hw: HardwareSpec = TPU_V5E):
        self.hw = hw

    def peak(self) -> float:
        return self.hw.peak_flops

    def time(self, call: KernelCall, dtype_bytes: int = 2) -> float:
        return self.raw_time(call.flops, call.bytes_moved,
                             dtype_bytes=dtype_bytes)

    def raw_time(self, flops: float, elems_moved: float, *,
                 dtype_bytes: int = 2) -> float:
        """Roofline seconds for explicit (FLOPs, elements-moved) counts:
        the same ``max(compute, memory)`` as :meth:`time`, for work that
        no per-kind ``bytes_moved`` formula expresses."""
        comp = flops / self.hw.peak_flops
        mem = elems_moved * dtype_bytes / self.hw.hbm_bw
        return max(comp, mem)


class TableProfile(KernelProfile):
    """Benchmarked per-call times (paper's Experiment 3 data structure).

    ``table[(kind, dims)] = seconds``. Exact lookups serve Experiment 3;
    for planner use on unseen shapes, falls back to nearest neighbour in
    log-dim space among same-kind entries, scaling by the FLOP ratio.
    """

    def __init__(self, peak_flops: float,
                 table: Optional[Dict[Tuple[str, Tuple[int, ...]], float]] = None):
        self._peak = peak_flops
        self.table: Dict[Tuple[str, Tuple[int, ...]], float] = dict(table or {})
        self._write_lock = threading.Lock()
        self._generation = 0
        # (table-ref, {(kind, ndims): [(logdims, dims, seconds), ...]});
        # rebuilt lazily whenever self.table has been rebound (record()
        # and every supported mutation path rebind rather than mutate).
        self._index: Optional[Tuple[Dict, Dict]] = None

    def peak(self) -> float:
        return self._peak

    @property
    def generation(self) -> int:
        """Monotonic mutation counter, bumped by every :meth:`record`.

        Consumers that memoise rankings derived from this table (the
        planner's plan cache) fold it into their keys, so online
        refinement invalidates stale decisions instead of freezing the
        first ranking forever.
        """
        return self._generation

    def observe_peak(self, flops_per_s: float) -> None:
        """Raise the recorded peak when a faster throughput is observed.

        Keeps :meth:`efficiency` (the paper's Fig. 1 quantity) meaningful
        as later sweeps measure kernels faster than the original
        calibration's best — without this, efficiency clamps at 1.0.
        """
        if flops_per_s > self._peak:
            self._peak = float(flops_per_s)

    def record(self, call: KernelCall, seconds: float) -> None:
        # Copy-on-write under a writer lock: readers (time/nearest iterate
        # the dict) hold the old mapping while recorders rebind — so the
        # planner's online refinement never trips "dict changed size
        # during iteration" in a planning thread — and the lock keeps two
        # recorders from losing each other's read-copy-rebind. Tables are
        # small (≤ ~10³ entries), so the copy is cheap relative to one
        # benchmark rep.
        with self._write_lock:
            self.table = {**self.table, (call.kind, call.dims): seconds}
            self._generation += 1

    def __contains__(self, call: KernelCall) -> bool:
        return (call.kind, call.dims) in self.table

    def _buckets(self) -> Dict:
        """Per-``(kind, ndims)`` entry index with vectorized log-dims.

        ``nearest`` used to scan the whole table per un-memoised call
        during ranking; the bucket restricts each query to same-kind,
        same-arity entries and turns the distance scan into one vectorized
        numpy reduction over a precomputed log-dim matrix (see the
        ``calibrate_nearest_query`` row in benchmarks/calibrate_bench.py).
        The index is rebuilt lazily when ``self.table`` has been rebound —
        every supported mutation path (:meth:`record`, the calibrate
        merge) rebinds rather than mutates in place, and readers snapshot
        one coherent (table, index) pair.
        """
        idx = self._index
        table = self.table
        if idx is not None and idx[0] is table:
            return idx[1]
        import numpy as np

        groups: Dict[Tuple[str, int], list] = {}
        for (kind, dims), t in table.items():
            groups.setdefault((kind, len(dims)), []).append((dims, t))
        buckets = {}
        for key, entries in groups.items():
            logdims = np.log(np.maximum(
                np.array([d for d, _ in entries], dtype=float), 2.0))
            buckets[key] = (logdims, entries)
        self._index = (table, buckets)
        return buckets

    def nearest(
        self, call: KernelCall,
    ) -> Optional[Tuple[Tuple[int, ...], float, float]]:
        """Closest same-kind entry in log-dim space.

        Returns ``(dims, seconds, squared_log_distance)`` or ``None`` when
        no same-kind entry exists. Shared by :meth:`time` and
        :class:`HybridProfile` so "which entry is closest" and "which entry
        we extrapolate from" can never disagree.
        """
        bucket = self._buckets().get((call.kind, len(call.dims)))
        if bucket is None:
            return None
        import numpy as np

        logdims, entries = bucket
        lg = np.log(np.maximum(np.array(call.dims, dtype=float), 2.0))
        dists = ((logdims - lg) ** 2).sum(axis=1)
        i = int(np.argmin(dists))
        dims, t = entries[i]
        return (dims, t, float(dists[i]))

    def extrapolate(
        self, call: KernelCall,
        near: Optional[Tuple[Tuple[int, ...], float, float]],
    ) -> float:
        """Scale a :meth:`nearest` hit to ``call``'s size.

        tri2full (0 FLOPs, memory-only) scales quadratically in the dim
        and costs 0 with no reference; compute kernels scale by FLOP
        ratio and raise without one.
        """
        if call.kind == "tri2full":
            if near is None:
                return 0.0
            dims0, t0, _ = near
            return t0 * (call.dims[0] ** 2) / (dims0[0] ** 2)
        if near is None:
            raise KeyError(f"no profile data for kernel kind {call.kind!r}")
        dims0, t0, _ = near
        f0 = KernelCall(call.kind, dims0).flops
        return t0 * (call.flops / max(1, f0))

    def time(self, call: KernelCall, dtype_bytes: int = 8) -> float:
        hit = self.table.get((call.kind, call.dims))
        if hit is not None:
            return hit
        return self.extrapolate(call, self.nearest(call))


class HybridProfile(KernelProfile):
    """Measured-where-known, analytical-elsewhere (paper's conjecture).

    The paper's conclusion proposes "combining FLOP counts with kernel
    performance models"; this profile is that combination as a per-call
    policy: a calibrated :class:`TableProfile` answers for shapes it has
    measured (exactly, or by same-kind nearest neighbour within
    ``max_log_dist`` of a recorded entry), and an analytical model
    (by default :class:`AnalyticalHopperProfile`) answers for everything
    else — so a
    partially calibrated machine still ranks *every* candidate algorithm.

    ``max_log_dist`` is the squared log-space distance beyond which a
    table entry is considered too remote to extrapolate from; the default
    0.5 ≈ each dim within ~2× of a measured one on average.
    """

    def __init__(self, table: TableProfile,
                 analytical: Optional[KernelProfile] = None,
                 max_log_dist: float = 0.5):
        self.table_profile = table
        self.analytical = analytical or AnalyticalHopperProfile()
        self.max_log_dist = max_log_dist

    def peak(self) -> float:
        return self.table_profile.peak()

    def _resolve(self, call: KernelCall) -> Tuple[str, Optional[float]]:
        """The one table-vs-analytical decision: ``(source, seconds)``.

        ``source()`` and ``time()`` both route here, so "which model
        answers" and "what it answers" can never diverge (they used to
        compute ``nearest`` independently). ``seconds`` is ``None`` iff
        the analytical member answers — the caller supplies
        ``dtype_bytes`` there.
        """
        hit = self.table_profile.table.get((call.kind, call.dims))
        if hit is not None:
            return "table", hit
        near = self.table_profile.nearest(call)
        if near is not None and near[2] <= self.max_log_dist:
            return "table", self.table_profile.extrapolate(call, near)
        return "analytical", None

    def source(self, call: KernelCall) -> str:
        """Which model answers for ``call``: ``"table"`` | ``"analytical"``."""
        return self._resolve(call)[0]

    def time(self, call: KernelCall, dtype_bytes: int = 8) -> float:
        src, seconds = self._resolve(call)
        if src == "table":
            return seconds
        return self.analytical.time(call, dtype_bytes)

    def record(self, call: KernelCall, seconds: float) -> None:
        self.table_profile.record(call, seconds)

    def observe_peak(self, flops_per_s: float) -> None:
        self.table_profile.observe_peak(flops_per_s)


def predict_algorithm_time(
    calls: Iterable[KernelCall],
    profile: KernelProfile,
    dtype_bytes: int = 8,
) -> float:
    """Paper's additive kernel-sequence model: T(alg) = Σ T(call).

    Experiment 3 shows this predicts 75–92 % of anomalies; it deliberately
    ignores inter-kernel cache coupling (paper §3.4.3), which is the
    residual error the paper attributes the remainder to.
    """
    return sum(profile.time(c, dtype_bytes) for c in calls)
