"""Operand validation shared by the kernel wrappers.

Counterpart of the reference package's ``kernels/_checks.py``. The port's
kernels mask their ragged edges themselves, so no dim has to divide a
block; what remains to check is that operands are float32 matrices (for
attention: 4-D float32 or bfloat16 tensors of a head_dim the kernel is
built for) on one device whose shared dims agree. Every failure is a
:class:`ValueError` naming the kernel and the offending dims, never a
bare ``assert`` (which ``python -O`` would strip, letting a mis-shaped
call read out of bounds on the card).
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


def check_attention(kernel: str, head_dims: Tuple[int, ...],
                    dtypes: Tuple[torch.dtype, ...], q: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    """q (B, H, S, D), k and v (B, Hkv, S, D): one dtype of ``dtypes``,
    one device, H a multiple of Hkv, D one of ``head_dims``."""
    operands = {"q": q, "k": k, "v": v}
    for name, t in operands.items():
        if t.dim() != 4:
            raise ValueError(f"{kernel}: {name} must be (B, H, S, D), got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in dtypes or t.dtype != q.dtype:
            raise ValueError(f"{kernel}: q, k, v must share one dtype of "
                             f"{[str(d) for d in dtypes]}, got q {q.dtype}, "
                             f"{name} {t.dtype}")
    if len({t.device for t in operands.values()}) > 1:
        detail = ", ".join(f"{n} on {t.device}" for n, t in operands.items())
        raise ValueError(f"{kernel}: operands on different devices: {detail}")
    check_same(kernel, "batch dim B", ("q.shape[0]", q.shape[0]),
               ("k.shape[0]", k.shape[0]), ("v.shape[0]", v.shape[0]))
    check_same(kernel, "sequence dim S", ("q.shape[2]", q.shape[2]),
               ("k.shape[2]", k.shape[2]), ("v.shape[2]", v.shape[2]))
    check_same(kernel, "head_dim D", ("q.shape[3]", q.shape[3]),
               ("k.shape[3]", k.shape[3]), ("v.shape[3]", v.shape[3]))
    check_same(kernel, "kv heads Hkv", ("k.shape[1]", k.shape[1]),
               ("v.shape[1]", v.shape[1]))
    h, hkv = q.shape[1], k.shape[1]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{kernel}: mismatched heads: H={h} query heads "
                         f"are not a multiple of Hkv={hkv} kv heads")
    if q.shape[3] not in head_dims:
        raise ValueError(f"{kernel}: head_dim D={q.shape[3]} is not one of "
                         f"the kernel's {list(head_dims)}")
    if window < 0:
        raise ValueError(f"{kernel}: window={window} must be >= 0")
