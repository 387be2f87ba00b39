"""Execution backends: the protocol, the walker, the registry, and the
``torch``/``cuda`` backends."""

from .base import (
    ExecutionBackend,
    KernelOps,
    fusable_pattern,
    get_backend,
    get_backend_class,
    num_inputs,
    operands_from_numpy,
    register_backend,
    registered_backends,
    synthetic_algorithm,
    walk_steps,
)
from .torch_backend import (
    CudaBackend,
    CudaOps,
    TorchBackend,
    TorchOps,
    register_torch_backends,
)

__all__ = [
    "CudaBackend", "CudaOps", "ExecutionBackend", "KernelOps",
    "TorchBackend", "TorchOps", "fusable_pattern", "get_backend",
    "get_backend_class", "num_inputs", "operands_from_numpy",
    "register_backend", "register_torch_backends", "registered_backends",
    "synthetic_algorithm", "walk_steps",
]
