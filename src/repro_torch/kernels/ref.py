"""Plain PyTorch versions of every hand-written kernel in this package.

Each function is the mathematical definition, with no tiling (float32
for the linear-algebra kernels; attention in float32 or bfloat16):
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


def gemm_syrk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lower triangle of (A @ B) @ (A @ B)ᵀ (strictly-upper entries zero)."""
    m1 = a @ b
    return torch.tril(m1 @ m1.mT)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None,
                    logit_softcap: float = 0.0,
                    window: int = 0) -> torch.Tensor:
    """Attention with GQA broadcast, optional causal mask, sliding window
    and Gemma-2 logit soft-capping; q (B, H, S, D), k/v (B, Hkv, S, D).

    Float32 logits, softmax, p rounded to v's dtype, then P·V accumulated
    in float32 and rounded once to q's dtype (the reference leaves that
    accumulation to XLA; the kernel accumulates in float32).
    """
    b, h, s, d = q.shape
    group = h // k.shape[1]
    if scale is None:
        scale = d ** -0.5
    kq = k.repeat_interleave(group, dim=1)
    vq = v.repeat_interleave(group, dim=1)
    logits = (q.float() @ kq.float().mT) * scale
    if logit_softcap > 0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    idx = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= idx[:, None] >= idx[None, :]
    if window > 0:
        mask &= idx[:, None] - idx[None, :] < window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return (p.to(v.dtype).float() @ vq.float()).to(q.dtype)
