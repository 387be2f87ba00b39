"""Execution backends: the protocol, the walker, the registry, and the
port's four backends.

=========  ==========================================  ===================
registry   what it executes                            fingerprint dtype
=========  ==========================================  ===================
``blas``   scipy BLAS on the host (paper protocol:     float64
           cache flush, median of ``reps``)
``numpy``  the numpy oracle on the host                float64
``torch``  plain ATen on a card or the CPU             float32 (default;
                                                       float64, bfloat16,
                                                       float16)
``cuda``   the hand-written kernels on a card (their   float32
           plain versions on the CPU)
=========  ==========================================  ===================

:func:`register_torch_backends` registers all four; registration is that
explicit call, never an import side effect.
"""

from .base import (
    ExecutionBackend,
    KernelOps,
    backend_default_dtype,
    backend_on,
    backend_shard_mode,
    fusable_pattern,
    get_backend,
    get_backend_class,
    make_backend,
    measure_seconds,
    num_inputs,
    operands_from_numpy,
    register_backend,
    registered_backends,
    synthetic_algorithm,
    synthetic_fused_algorithm,
    walk_steps,
)
from .blas import BlasBackend, CacheFlusher
from .numpy_backend import NumpyBackend, reference_execute
from .torch_backend import (
    TORCH_DTYPES,
    CudaBackend,
    CudaOps,
    TorchBackend,
    TorchOps,
    fusion_enabled,
    register_torch_backends,
    timing_mode,
)

__all__ = [
    "BlasBackend", "CacheFlusher", "CudaBackend", "CudaOps",
    "ExecutionBackend", "KernelOps", "NumpyBackend", "TORCH_DTYPES",
    "TorchBackend", "TorchOps", "backend_default_dtype", "backend_on",
    "backend_shard_mode", "fusable_pattern", "fusion_enabled",
    "get_backend", "get_backend_class", "make_backend", "measure_seconds",
    "num_inputs",
    "operands_from_numpy", "reference_execute", "register_backend",
    "register_torch_backends", "registered_backends", "synthetic_algorithm",
    "synthetic_fused_algorithm", "timing_mode", "walk_steps",
]
