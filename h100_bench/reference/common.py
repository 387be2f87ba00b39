"""Plain float32 pieces that every family's reference shares: norms,
the loss, the tied head, block checkpointing, and the precision of the
matrix products.

``Precision`` says how the inputs of each matrix product are rounded. The
reference runs in ``float32`` with TF32 off; the control of the
correctness check runs in ``fp8``: every weight and every activation that
enters a matrix product is rounded to float8 e4m3 with a per-tensor
scale, the step below the bfloat16 that the configurations state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0   # largest finite float8 e4m3fn


def strict_float32() -> None:
    """Matrix products and convolutions in full float32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Precision:
    """``float32`` leaves the inputs of a product as they are; ``fp8``
    rounds each to float8 e4m3 with the scale amax / 448, the gradient
    passing straight through the rounding."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (q - x.detach())

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.round(x) @ self.round(w)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token cross-entropy of (B, S, V) logits."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def embed_logits(h: torch.Tensor, table: torch.Tensor, vocab: int,
                 prec: Precision) -> torch.Tensor:
    """Tied output head over the real vocabulary (pad rows carry no
    probability mass)."""
    return prec.mm(h, table[:vocab].t())


def maybe_checkpoint(fn, x: torch.Tensor, on: bool) -> torch.Tensor:
    if not on:
        return fn(x)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, x, use_reentrant=False)
