"""Operand validation shared by the kernel wrappers.

Counterpart of the reference package's ``kernels/_checks.py``. The port's
kernels mask their ragged edges themselves, so no dim has to divide a
block; what remains to check is that operands are float32 matrices on one
device whose shared dims agree. Every failure is a :class:`ValueError`
naming the kernel and the offending dims, never a bare ``assert`` (which
``python -O`` would strip, letting a mis-shaped call read out of bounds
on the card).
"""

from __future__ import annotations

from typing import Tuple

import torch


def check_same(kernel: str, what: str,
               *values: Tuple[str, int]) -> None:
    """Each value is ``(source_name, dim)``; raises ``ValueError`` when
    they disagree (operand shape mismatch on a shared dimension)."""
    dims = {d for _, d in values}
    if len(dims) > 1:
        detail = ", ".join(f"{name}={d}" for name, d in values)
        raise ValueError(f"{kernel}: {what} mismatch: {detail}")


def check_matrices(kernel: str, **operands: torch.Tensor) -> None:
    """Every operand is a 2-D float32 tensor, all on one device."""
    devices = set()
    for name, t in operands.items():
        if t.dim() != 2:
            raise ValueError(
                f"{kernel}: {name} must be a matrix, got shape "
                f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(
                f"{kernel}: {name} must be float32 (the backend's "
                f"measured dtype label), got {t.dtype}")
        devices.add(t.device)
    if len(devices) > 1:
        detail = ", ".join(f"{n} on {t.device}" for n, t in operands.items())
        raise ValueError(f"{kernel}: operands on different devices: {detail}")
