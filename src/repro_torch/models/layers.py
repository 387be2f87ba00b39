"""Shared building blocks: init helpers, norms, MLPs, RoPE, embeddings.

Counterpart of the reference's ``models/layers.py``. A parameter pytree
there is an ``nn.Module`` here with the same attribute names (``w`` of a
dense or embedding, ``g`` of a norm, ``gate``/``up``/``down`` of an MLP),
so a state-dict key such as ``blocks.3.attn.wq.w`` names the reference
leaf ``params["blocks"]["attn"]["wq"]["w"][3]``. Modules hold parameters
only; the functions below apply them, as the reference's do. Each module
names its parameters' logical axes in ``param_axes`` ({attribute:
axes}), the reference's axes tree (read by
:func:`repro_torch.models.api.param_axes`). Weights are
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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.sharding.context import (grad_in_layout, replicate,
                                          shard_offset, whole_within)


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
    """``w`` (d_in, d_out) ~ N(0, 1/d_in) unless ``scale`` is given; a
    model's dense layers name the logical ``axes`` of its two dims."""

    def __init__(self, d_in: int, d_out: int,
                 axes: Optional[Tuple[str, str]] = None, *, generator,
                 device, dtype, scale: Optional[float] = None):
        super().__init__()
        scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
        self.w = _normal(generator, (d_in, d_out), scale, device, dtype)
        self.param_axes = {} if axes is None else {"w": tuple(axes)}


class Embed(nn.Module):
    """``w`` (vocab, d) ~ N(0, 0.02²)."""

    def __init__(self, vocab: int, d: int, *, generator, device, dtype):
        super().__init__()
        self.w = _normal(generator, (vocab, d), 0.02, device, dtype)
        self.param_axes = {"w": ("vocab", "embed")}


class RMSNorm(nn.Module):
    """``g`` (d,), ones; ``d`` is the width it normalises, which need not
    be the model's (Zamba2's shared block normalises [hidden,
    embedding], 2·d_model wide)."""

    def __init__(self, d: int, *, device, dtype):
        super().__init__()
        self.g = nn.Parameter(torch.ones((d,), device=device, dtype=dtype),
                              requires_grad=False)
        self.param_axes = {"g": ("embed",)}


class GluMLP(nn.Module):
    def __init__(self, d: int, d_ff: int, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.gate = Dense(d, d_ff, ("embed", "ffn"), **kw)
        self.up = Dense(d, d_ff, ("embed", "ffn"), **kw)
        self.down = Dense(d_ff, d, ("ffn", "embed"), **kw)


class MLP(nn.Module):
    """Plain 2-layer MLP (whisper)."""

    def __init__(self, d: int, d_ff: int, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.up = Dense(d, d_ff, ("embed", "ffn"), **kw)
        self.down = Dense(d_ff, d, ("ffn", "embed"), **kw)


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
    # on a DTensor the product folds the leading dims into one, both ways
    return grad_in_layout(whole_within(x, 0, x.ndim - 2) @ p.w.to(x.dtype))


def embed(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(p.w, DTensor):
        return _embed_sharded(p.w, tokens)
    return p.w[tokens]


def _embed_sharded(w: DTensor, tokens: torch.Tensor) -> DTensor:
    """The lookup of a vocab-sharded table, the reference's partitioned
    gather: each rank looks its ids up in its own rows of the vocabulary
    (the FSDP-sharded ``embed`` dim gathered, as any FSDP weight is), the
    ids outside them give zeros, and the partial sums over the vocab's
    mesh dims are reduced into the residual stream's layout: the sequence
    over them where they divide it (a reduce-scatter), else replicated."""
    mesh = w.device_mesh
    tokens = replicate(tokens, mesh)
    vocab = [i for i, pl in enumerate(w.placements)
             if isinstance(pl, Shard) and pl.dim == 0]
    wp = [Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim)]
    tp = [Replicate() if i in vocab else pl
          for i, pl in enumerate(tokens.placements)]
    # rows gathered from other ranks' tokens add up over those mesh dims
    gp = [Shard(0) if i in vocab else Partial() if isinstance(pl, Shard)
          else Replicate() for i, pl in enumerate(tp)]
    first = shard_offset(w.shape, mesh, wp, 0)

    def lookup(w_local, ids):
        ids = ids - first
        inside = (ids >= 0) & (ids < w_local.shape[0])
        rows = w_local[torch.where(inside, ids, 0)]
        return rows * inside[..., None].to(rows.dtype)

    out = local_map(lookup, out_placements=[
        Partial() if i in vocab else pl for i, pl in enumerate(tp)],
        in_placements=(wp, tp), in_grad_placements=(gp, tp),
        device_mesh=mesh, redistribute_inputs=True)(w, tokens)
    n = math.prod(mesh.size(i) for i in vocab)
    seq = Shard(1) if out.ndim > 1 and out.shape[1] % n == 0 \
        and out.shape[1] >= n else Replicate()
    return out.redistribute(mesh, [seq if i in vocab else pl
                                   for i, pl in enumerate(tp)])


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping; identity when cap <= 0."""
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU, x·Φ(x) with the error function (Zamba2's
    ``hidden_act`` "gelu")."""
    return F.gelu(x)


#: A GLU's activation by the name a config gives it.
ACTIVATIONS = {"silu": F.silu, "gelu": gelu, "gelu_exact": gelu_exact}


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
