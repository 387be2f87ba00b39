"""Public entry points of the port's kernels.

Counterpart of the reference package's ``kernels/ops.py``. Each function
validates its operands (a :class:`ValueError` naming the kernel and the
mismatched dims), then dispatches on where the operands lie:

* on the card, it launches the hand-written CUDA kernel, or raises —
  there is no fallback to the plain version;
* on the CPU, it runs the plain PyTorch version in :mod:`.ref`, which is
  what the CPU tests compare with the reference package.

The five matrix kernels take an optional ``config=``: a launch of the
kernel's own (a tuned one, from :mod:`repro_torch.core.tuning`), made in
place of the one its launch rule picks. The plain version ignores it.
Each also takes a batch: every operand (batch, rows, cols) with one
batch size, the result (batch, m, n). On the card a batch is one launch,
its instances a grid axis of the kernel, and counts one launch; the
dims the messages name are the matrix dims, whatever the batch.

``flash_attention`` keeps the reference's (B, H, S, D) layout at its
boundary and goes through the custom operator
``repro_torch::flash_attention``; given DTensors (a sharded prefill) it
runs that operator on each rank's local heads
(:func:`.flash_attention.flash_attention_sharded`). ``tri2full`` is data
movement (the paper charges it no flops) and stays a plain tensor op on
either device, as in the reference. ``ssd_chunk`` (the SSD's fused
intra-chunk stage, :mod:`.ssd_chunk`) and ``flash_train`` (training's
attention, forward and backward, :mod:`.flash_train`) have no entry here:
the models call their modules directly; they are in :data:`KERNELS` for
their launch counters.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch.distributed.tensor import DTensor

from . import chain_gemm as _chain_gemm
from . import flash_attention as _flash
from . import flash_train as _flash_train
from . import gemm as _gemm
from . import gemm_syrk as _gemm_syrk
from . import ref
from . import ssd_chunk as _ssd_chunk
from . import symm as _symm
from . import syrk as _syrk
from ._checks import check_attention, check_matrices, check_same

#: The kernel modules, each holding its own ``launches`` counter.
KERNELS = {"gemm": _gemm, "syrk": _syrk, "symm": _symm,
           "chain_gemm": _chain_gemm, "gemm_syrk": _gemm_syrk,
           "flash_attention": _flash, "ssd_chunk": _ssd_chunk,
           "flash_train": _flash_train}


def launch_counts() -> Dict[str, int]:
    """CUDA launches per kernel so far in this process."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def add_launches(counts: Mapping[str, int]) -> None:
    """Add ``counts`` to the kernels' launch counters.

    The wrappers count a launch where they make it. A replayed CUDA graph
    runs no Python, and a capture executes nothing, so the graph timing of
    :mod:`repro_torch.core.backends.torch_backend` takes back what its
    capture counted and credits each replay with it: the counters stay
    the number of kernel executions on the card.
    """
    for name, n in counts.items():
        KERNELS[name].launches += n


def _on_card(kernel: str, t: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{kernel}: no kernel for device {t.device}")


def gemm(a: torch.Tensor, b: torch.Tensor, config=None) -> torch.Tensor:
    """C = A·B."""
    check_matrices("gemm", A=a, B=b)
    check_same("gemm", "contraction dim k",
               ("A.shape[1]", a.shape[-1]), ("B.shape[0]", b.shape[-2]))
    if _on_card("gemm", a):
        return _gemm.gemm_cuda(a, b, config)
    return ref.gemm(a, b)


def syrk(a: torch.Tensor, config=None) -> torch.Tensor:
    """Lower triangle of A·Aᵀ (strictly-upper entries zero)."""
    check_matrices("syrk", A=a)
    if _on_card("syrk", a):
        return _syrk.syrk_cuda(a, config)
    return ref.syrk(a)


def symm(s_lower: torch.Tensor, b: torch.Tensor,
         config=None) -> torch.Tensor:
    """C = S·B, S symmetric and stored in its lower triangle (the strict
    upper triangle is never read)."""
    check_matrices("symm", S=s_lower, B=b)
    check_same("symm", "symmetric dim m", ("S.shape[0]", s_lower.shape[-2]),
               ("S.shape[1]", s_lower.shape[-1]), ("B.shape[0]", b.shape[-2]))
    if _on_card("symm", b):
        return _symm.symm_cuda(s_lower, b, config)
    return ref.symm(s_lower, b)


def chain_gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               config=None) -> torch.Tensor:
    """(A·B)·C without materializing A·B (on the card)."""
    check_matrices("chain_gemm", A=a, B=b, C=c)
    check_same("chain_gemm", "contraction dim k",
               ("A.shape[1]", a.shape[-1]), ("B.shape[0]", b.shape[-2]))
    check_same("chain_gemm", "contraction dim l",
               ("B.shape[1]", b.shape[-1]), ("C.shape[0]", c.shape[-2]))
    if _on_card("chain_gemm", a):
        return _chain_gemm.chain_gemm_cuda(a, b, c, config)
    return ref.chain_gemm(a, b, c)


def gemm_syrk(a: torch.Tensor, b: torch.Tensor, config=None) -> torch.Tensor:
    """Lower triangle of (A·B)(A·B)ᵀ without materializing A·B (on the
    card); strictly-upper entries zero."""
    check_matrices("gemm_syrk", A=a, B=b)
    check_same("gemm_syrk", "contraction dim k",
               ("A.shape[1]", a.shape[-1]), ("B.shape[0]", b.shape[-2]))
    if _on_card("gemm_syrk", a):
        return _gemm_syrk.gemm_syrk_cuda(a, b, config)
    return ref.gemm_syrk(a, b)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    logit_softcap: float = 0.0,
                    window: int = 0) -> torch.Tensor:
    """Attention over q (B, H, S, D) and k/v (B, Hkv, S, D) with GQA,
    optional causal mask, sliding window and logit soft-cap; any S (on the
    card the kernel masks the ragged tile, so there is no fallback)."""
    check_attention("flash_attention", _flash.HEAD_DIMS,
                    tuple(_flash.DTYPES), q, k, v, window)
    if scale is None:
        scale = q.shape[3] ** -0.5
    if isinstance(q, DTensor):
        return _flash.flash_attention_sharded(
            q, k, v, causal=causal, scale=scale,
            logit_softcap=logit_softcap, window=window)
    return torch.ops.repro_torch.flash_attention(
        q, k, v, causal, float(scale), float(logit_softcap), int(window))


def tri2full(t: torch.Tensor) -> torch.Tensor:
    """Mirror the lower triangle into a full symmetric matrix."""
    check_matrices("tri2full", T=t)
    check_same("tri2full", "square dim", ("T.shape[0]", t.shape[-2]),
               ("T.shape[1]", t.shape[-1]))
    return ref.tri2full(t)
