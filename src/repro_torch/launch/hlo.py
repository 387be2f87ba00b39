"""Per-device costs of a traced step: collective traffic, FLOPs, bytes,
peak memory and the three roofline terms.

Counterpart of the reference's ``launch/hlo.py``, which parses the
partitioned HLO text of a compiled dry-run. The port has no HLO: it
records what one rank executes. :class:`CostRecorder` is a
``TorchDispatchMode`` that lets DTensor desugar each op first (it
returns ``NotImplemented`` on DTensor arguments, as ``CommDebugMode``
does), so it sees the *local* aten ops on this rank's shards and the
``_c10d_functional`` collectives DTensor issues. It records:

  * FLOPs of every local op with a formula in
    ``torch.utils.flop_counter`` (matrix products, attention, the
    flash kernel's custom operator) — per device, not global;
  * bytes: input plus output bytes of every local op that is not a view
    (an *unfused* count: each op reads and writes memory; XLA's count is
    of fused kernels, so the two are never compared);
  * collectives, each with its result bytes (the reference's convention:
    for an all-reduce the wire traffic is ~2·(n−1)/n× that), by kind;
  * the live bytes of the tensors the ops create, and their peak.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d",
                          "_dtensor")
# (substring of the op name, kind), first match wins
_COLLECTIVE_KINDS = (
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    ("permute", "collective-permute"), ("send", "collective-permute"),
    ("broadcast", "broadcast"),
)


def collective_kind(func) -> str:
    """The collective an op is, '' when it is none."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return ""
    name = func._schema.name.split("::")[-1]
    for key, kind in _COLLECTIVE_KINDS:
        if key in name:
            return kind
    return ""


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


class Collective(NamedTuple):
    kind: str
    bytes: int
    shape: Tuple[int, ...]
    dtype: str


_mute = threading.local()


@contextlib.contextmanager
def muted():
    """Ops run inside are no rank's work (layout arithmetic): a
    :class:`CostRecorder` does not record them."""
    _mute.depth = getattr(_mute, "depth", 0) + 1
    try:
        yield
    finally:
        _mute.depth -= 1


class CostRecorder(TorchDispatchMode):
    """Records one rank's costs of what runs under it (see the module
    docstring). ``flops``, ``bytes`` and ``trace`` accumulate; ``live``
    and ``peak`` are the bytes of the tensors created under it that are
    still referenced, and their high-water mark."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.trace: List[Collective] = []
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def __enter__(self):
        # DTensor derives each new op's global output shape by running it
        # on global-shaped fake tensors (sharding propagation); those runs
        # are not this rank's work, so the recorder is muted there.
        prop = DTensor._op_dispatcher.sharding_propagator
        derive = getattr(prop, "_propagate_tensor_meta_non_cached", None)
        if derive is None:
            raise RuntimeError("CostRecorder: this torch's DTensor has no "
                               "_propagate_tensor_meta_non_cached to mute")

        def derive_muted(op_schema):
            with muted():
                return derive(op_schema)

        prop._propagate_tensor_meta_non_cached = derive_muted
        return super().__enter__()

    def __exit__(self, *exc):
        prop = DTensor._op_dispatcher.sharding_propagator
        prop.__dict__.pop("_propagate_tensor_meta_non_cached", None)
        return super().__exit__(*exc)

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, t) -> None:
        if not isinstance(t, torch.Tensor) or t._is_view() \
                or t in self._seen:
            return
        n = _nbytes(t)
        self._seen[t] = True
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_mute, "depth", 0):
            return out
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        kind = collective_kind(func)
        if kind:
            for t in outs:
                self.trace.append(Collective(kind, _nbytes(t),
                                             tuple(t.shape), str(t.dtype)))
            return out
        if func.namespace in _COLLECTIVE_NAMESPACES:   # wait_tensor etc.
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self._track(t)
        return out


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_.values())

    @property
    def total_count(self) -> int:
        return sum(self.counts.values())

    def summary(self) -> str:
        parts = [
            f"{k}: n={self.counts[k]} bytes={self.bytes_[k]:,}"
            for k in sorted(self.counts)
        ]
        return "; ".join(parts) if parts else "none"


def collective_stats(trace: Sequence[Collective]) -> CollectiveStats:
    """Counts and result bytes by kind of a recorded collective trace."""
    counts: Dict[str, int] = {}
    bytes_: Dict[str, int] = {}
    for c in trace:
        counts[c.kind] = counts.get(c.kind, 0) + 1
        bytes_[c.kind] = bytes_.get(c.kind, 0) + c.bytes
    return CollectiveStats(counts=counts, bytes_=bytes_)


def top_collectives(trace: Sequence[Collective], n: int = 20):
    """The ``n`` largest collectives: (bytes, kind, shape, dtype)."""
    out = [(c.bytes, c.kind, c.shape, c.dtype) for c in trace]
    out.sort(reverse=True)
    return out[:n]


# H100 SXM data-sheet figures (dense, no sparsity).
H100_BF16_FLOPS = 989e12
H100_HBM3_BW = 3.35e12
#: NVLink 4 within an 8-GPU HGX node, per GPU.
NVLINK4_BW = 900e9
#: NDR InfiniBand, 400 Gb/s per GPU: what an axis crossing nodes rides.
NDR_IB_BW = 50e9
GPUS_PER_NODE = 8


def link_bandwidth(axis_sizes: Dict[str, int],
                   gpus_per_node: int = GPUS_PER_NODE) -> float:
    """The slowest link a mesh's collectives cross, with devices numbered
    row-major over the mesh (the innermost axis contiguous on a node):
    NVLink when the whole mesh sits in one node, InfiniBand otherwise. On
    the production meshes the 16-wide ``model`` axis alone spans two
    8-GPU nodes."""
    n = 1
    for size in axis_sizes.values():
        n *= size
    return NVLINK4_BW if n <= gpus_per_node else NDR_IB_BW


@dataclasses.dataclass
class Roofline:
    """Three-term roofline for one (arch × shape × mesh) cell, with the
    H100's figures by default."""

    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    chips: int
    peak_flops: float = H100_BF16_FLOPS
    hbm_bw: float = H100_HBM3_BW
    link_bw: float = NDR_IB_BW

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def model_flops_ratio(self, model_flops_total: float) -> float:
        """MODEL_FLOPS / recorded FLOPs (total across devices)."""
        total = self.flops_per_device * self.chips
        return model_flops_total / total if total else 0.0

    def roofline_fraction(self, model_flops_total: float) -> float:
        """Useful-FLOPs throughput achievable vs the device's peak, given
        the dominant term: (MODEL_FLOPS/chips/t_bound) / peak."""
        if self.t_bound <= 0:
            return 0.0
        ach = model_flops_total / self.chips / self.t_bound
        return ach / self.peak_flops
