"""Execution backends: the protocol, the walker, the registry, and the
``torch``/``cuda`` backends."""

from .base import (
    ExecutionBackend,
    KernelOps,
    backend_default_dtype,
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
from .torch_backend import (
    CudaBackend,
    CudaOps,
    TorchBackend,
    TorchOps,
    fusion_enabled,
    register_torch_backends,
    timing_mode,
)

__all__ = [
    "CudaBackend", "CudaOps", "ExecutionBackend", "KernelOps",
    "TorchBackend", "TorchOps", "backend_default_dtype",
    "backend_shard_mode", "fusable_pattern", "fusion_enabled",
    "get_backend", "get_backend_class", "make_backend", "measure_seconds",
    "num_inputs",
    "operands_from_numpy", "register_backend", "register_torch_backends",
    "registered_backends", "synthetic_algorithm",
    "synthetic_fused_algorithm", "timing_mode", "walk_steps",
]
