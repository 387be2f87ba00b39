"""Shared building blocks: init helpers, norms, MLPs, RoPE, embeddings.

Counterpart of the reference's ``models/layers.py``. A parameter pytree
there is an ``nn.Module`` here with the same attribute names (``w`` of a
dense or embedding, ``g`` of a norm, ``gate``/``up``/``down`` of an MLP),
so a state-dict key such as ``blocks.3.attn.wq.w`` names the reference
leaf ``params["blocks"]["attn"]["wq"]["w"][3]``. Modules hold parameters
only; the functions below apply them, as the reference's do. Weights are
drawn from the reference's distributions with an explicit
``torch.Generator`` (the numbers differ from ``jax.random``'s; the tests
carry the reference's weights across with :mod:`.convert`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names the CPU; no silent fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU explicitly")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def _normal(generator: Optional[torch.Generator], shape: Tuple[int, ...],
            scale: float, device, dtype) -> nn.Parameter:
    w = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    return nn.Parameter(w.mul_(scale), requires_grad=False)


# ------------------------------------------------------------- modules ---

class Dense(nn.Module):
    """``w`` (d_in, d_out) ~ N(0, 1/d_in) unless ``scale`` is given."""

    def __init__(self, d_in: int, d_out: int, *, generator, device, dtype,
                 scale: Optional[float] = None):
        super().__init__()
        scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
        self.w = _normal(generator, (d_in, d_out), scale, device, dtype)


class Embed(nn.Module):
    """``w`` (vocab, d) ~ N(0, 0.02²)."""

    def __init__(self, vocab: int, d: int, *, generator, device, dtype):
        super().__init__()
        self.w = _normal(generator, (vocab, d), 0.02, device, dtype)


class RMSNorm(nn.Module):
    """``g`` (d,), ones."""

    def __init__(self, d: int, *, device, dtype):
        super().__init__()
        self.g = nn.Parameter(torch.ones((d,), device=device, dtype=dtype),
                              requires_grad=False)


class GluMLP(nn.Module):
    def __init__(self, d: int, d_ff: int, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.gate = Dense(d, d_ff, **kw)
        self.up = Dense(d, d_ff, **kw)
        self.down = Dense(d_ff, d, **kw)


class MLP(nn.Module):
    """Plain 2-layer MLP (whisper)."""

    def __init__(self, d: int, d_ff: int, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.up = Dense(d, d_ff, **kw)
        self.down = Dense(d_ff, d, **kw)


# ----------------------------------------------------------- functions ---

def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in float32, cast back. ``plus_one=True`` uses the gemma
    convention g ← (1 + g)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps)
    g = p.g.float()
    if plus_one:
        g = 1.0 + g
    return (xn * g).to(x.dtype)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    return x @ p.w.to(x.dtype)


def embed(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    return p.w[tokens]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping; identity when cap <= 0."""
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ----------------------------------------------------------------- RoPE ---

def rope_frequencies(dh: int, max_pos: int, theta: float = 10000.0,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=device) / dh))
    pos = torch.arange(max_pos, dtype=torch.float32, device=device)
    ang = torch.outer(pos, inv)               # (max_pos, dh/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) absolute positions. Rotates the
    two halves of each head (not interleaved pairs), in float32."""
    c = cos[positions][:, :, None, :]         # (B, S, 1, Dh/2)
    s = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- MLPs ---

def glu_mlp(p: GluMLP, x: torch.Tensor,
            activation: str = "silu") -> torch.Tensor:
    g = dense(p.gate, x)
    u = dense(p.up, x)
    act = F.silu if activation == "silu" else gelu
    return dense(p.down, act(g) * u)


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return dense(p.down, gelu(dense(p.up, x)))
