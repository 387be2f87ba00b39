"""Plain PyTorch versions of every hand-written kernel in this package.

Each function is the mathematical definition in float32, with no tiling:
what the CPU tests compare against the reference package, what the
kernel wrappers run for tensors on the CPU, and what ``chip_smoke.py``
holds each CUDA kernel against on the card.
"""

from __future__ import annotations

import torch


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B."""
    return a @ b


def syrk(a: torch.Tensor) -> torch.Tensor:
    """Lower triangle of A @ Aᵀ (strictly-upper entries zero)."""
    return torch.tril(a @ a.mT)


def tri2full(t: torch.Tensor) -> torch.Tensor:
    """Mirror the lower triangle into a full symmetric matrix."""
    return torch.tril(t) + torch.tril(t, -1).mT


def symm(s_lower: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = S @ B where S is symmetric, stored in the lower triangle of
    ``s_lower`` (strictly-upper entries ignored)."""
    return tri2full(s_lower) @ b


def chain_gemm(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """(A @ B) @ C."""
    return (a @ b) @ c
