"""Public entry points of the port's kernels.

Counterpart of the reference package's ``kernels/ops.py``. Each function
validates its operands (a :class:`ValueError` naming the kernel and the
mismatched dims), then dispatches on where the operands lie:

* on the card, it launches the hand-written CUDA kernel, or raises —
  there is no fallback to the plain version;
* on the CPU, it runs the plain PyTorch version in :mod:`.ref`, which is
  what the CPU tests compare with the reference package.

``tri2full`` is data movement (the paper charges it no flops) and stays a
plain tensor op on either device, as in the reference.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import chain_gemm as _chain_gemm
from . import gemm as _gemm
from . import gemm_syrk as _gemm_syrk
from . import ref
from . import symm as _symm
from . import syrk as _syrk
from ._checks import check_matrices, check_same

#: The kernel modules, each holding its own ``launches`` counter.
KERNELS = {"gemm": _gemm, "syrk": _syrk, "symm": _symm,
           "chain_gemm": _chain_gemm, "gemm_syrk": _gemm_syrk}


def launch_counts() -> Dict[str, int]:
    """CUDA launches per kernel so far in this process."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def _on_card(kernel: str, t: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{kernel}: no kernel for device {t.device}")


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A·B."""
    check_matrices("gemm", A=a, B=b)
    check_same("gemm", "contraction dim k",
               ("A.shape[1]", a.shape[1]), ("B.shape[0]", b.shape[0]))
    if _on_card("gemm", a):
        return _gemm.gemm_cuda(a, b)
    return ref.gemm(a, b)


def syrk(a: torch.Tensor) -> torch.Tensor:
    """Lower triangle of A·Aᵀ (strictly-upper entries zero)."""
    check_matrices("syrk", A=a)
    if _on_card("syrk", a):
        return _syrk.syrk_cuda(a)
    return ref.syrk(a)


def symm(s_lower: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = S·B, S symmetric and stored in its lower triangle (the strict
    upper triangle is never read)."""
    check_matrices("symm", S=s_lower, B=b)
    check_same("symm", "symmetric dim m", ("S.shape[0]", s_lower.shape[0]),
               ("S.shape[1]", s_lower.shape[1]), ("B.shape[0]", b.shape[0]))
    if _on_card("symm", b):
        return _symm.symm_cuda(s_lower, b)
    return ref.symm(s_lower, b)


def chain_gemm(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """(A·B)·C without materializing A·B (on the card)."""
    check_matrices("chain_gemm", A=a, B=b, C=c)
    check_same("chain_gemm", "contraction dim k",
               ("A.shape[1]", a.shape[1]), ("B.shape[0]", b.shape[0]))
    check_same("chain_gemm", "contraction dim l",
               ("B.shape[1]", b.shape[1]), ("C.shape[0]", c.shape[0]))
    if _on_card("chain_gemm", a):
        return _chain_gemm.chain_gemm_cuda(a, b, c)
    return ref.chain_gemm(a, b, c)


def gemm_syrk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lower triangle of (A·B)(A·B)ᵀ without materializing A·B (on the
    card); strictly-upper entries zero."""
    check_matrices("gemm_syrk", A=a, B=b)
    check_same("gemm_syrk", "contraction dim k",
               ("A.shape[1]", a.shape[1]), ("B.shape[0]", b.shape[0]))
    if _on_card("gemm_syrk", a):
        return _gemm_syrk.gemm_syrk_cuda(a, b)
    return ref.gemm_syrk(a, b)


def tri2full(t: torch.Tensor) -> torch.Tensor:
    """Mirror the lower triangle into a full symmetric matrix."""
    check_matrices("tri2full", T=t)
    check_same("tri2full", "square dim", ("T.shape[0]", t.shape[0]),
               ("T.shape[1]", t.shape[1]))
    return ref.tri2full(t)
