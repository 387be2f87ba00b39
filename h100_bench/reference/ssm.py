"""The ``ssm`` family's reference: the Mamba2 language model
(arXiv:2405.21060) in plain float32 PyTorch.

A model is a dict of tensors keyed by parameter name and the
configuration dict of ``h100_bench/configs/<name>.json``: token
embedding; ``n_layers`` blocks x ← x + mixer(rmsnorm(x)); final rmsnorm;
tied output head. The mixer projects to (z, x, B, C, Δt), convolves
(x, B, C) causally and applies SiLU, runs the SSD with A = −exp(a_log)
and Δt = softplus(Δt + dt_bias), adds D·x, gates with SiLU(z),
normalises and projects back. The SSD is written in its chunked form
with every decay summed directly (no difference of large cumulative
sums), with no kernel, cache or batching trick.

The names are those of the benchmark's weights (``param_spec``); the
harness hands the same tensors to the program under those names.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .common import Precision, embed_logits, maybe_checkpoint, rmsnorm

Params = Dict[str, torch.Tensor]


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: x (B, S, C), w (K, C), b (C,);
    out[t] = b + Σ_i w[i] · x[t - (K-1) + i], zeros before the start."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = b.expand_as(x)
    for i in range(k):
        out = out + xp[:, i:i + s] * w[i]
    return out


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) → (..., T, T): out[i, j] = Σ_{j<k≤i} a_k for i ≥ j and
    −inf above the diagonal, each sum taken directly."""
    t = a.shape[-1]
    strict = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device),
                        diagonal=-1)
    rep = a[..., :, None].expand(*a.shape, t).masked_fill(~strict, 0.0)
    out = torch.cumsum(rep, dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    return out.masked_fill(~keep, -math.inf)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        bmat: torch.Tensor, cmat: torch.Tensor, chunk: int) -> torch.Tensor:
    """The SSD layer, h_t = exp(Δt_t·a)·h_{t-1} + Δt_t·B_t·x_tᵀ and
    y_t = C_t·h_t from h_{-1} = 0, in chunks of ``chunk`` positions.

    x (B, S, H, P), dt (B, S, H), a (H,) negative, bmat / cmat (B, S, G, N)
    with the H heads split evenly over the G groups → y (B, S, H, P)."""
    b, s, h, p = x.shape
    g, n = bmat.shape[2:]
    q = math.gcd(s, chunk)
    c = s // q
    bh = bmat.repeat_interleave(h // g, dim=2).reshape(b, c, q, h, n)
    ch = cmat.repeat_interleave(h // g, dim=2).reshape(b, c, q, h, n)
    xd = (x * dt[..., None]).reshape(b, c, q, h, p)
    da = (dt * a).reshape(b, c, q, h).permute(0, 3, 1, 2)   # (B, H, c, q)
    # within a chunk: y_i = Σ_{j≤i} (C_i·B_j) exp(Σ_{j<k≤i} da_k) xd_j
    decay = torch.exp(segsum(da))                            # (B,H,c,q,q)
    scores = torch.einsum("bcihn,bcjhn->bhcij", ch, bh) * decay
    y = torch.einsum("bhcij,bcjhp->bcihp", scores, xd)
    # the state each chunk leaves: Σ_j exp(Σ_{k>j} da_k) B_j xd_jᵀ
    after = torch.flip(torch.cumsum(torch.flip(da, [-1]), -1), [-1]) - da
    states = torch.einsum("bcjhn,bhcj,bcjhp->bchnp", bh, torch.exp(after), xd)
    # the state entering chunk z: Σ_{c<z} exp(Σ_{c<m<z} total_m) states_c
    total = da.sum(dim=-1)                                   # (B, H, c)
    carry = torch.exp(segsum(F.pad(total, (1, 0))))[..., :-1, 1:]
    entering = torch.einsum("bhzc,bchnp->bzhnp", carry, states)
    # what it adds inside chunk z: C_i exp(Σ_{k≤i} da_k) h_entering
    into = torch.exp(torch.cumsum(da, dim=-1))               # (B, H, c, q)
    y = y + torch.einsum("bcihn,bhci,bchnp->bcihp", ch, into, entering)
    return y.reshape(b, s, h, p)


#: How a leaf is drawn from the seed: ("normal", std), ("gain",) =
#: 1 + 0.1·N(0, 1), ("bias",) = 0.02·N(0, 1), ("a_log",) = log U(1, 16),
#: ("dt_bias",) = softplus⁻¹ of a log-uniform Δt in [1e-3, 1e-1].
Spec = List[Tuple[str, Tuple[int, ...], Tuple]]


def _ssm_sizes(cfg: dict):
    s = cfg["ssm"]
    gn = s["n_groups"] * s["d_state"]
    return s, gn, s["d_inner"] + 2 * gn


def param_spec(cfg: dict) -> Spec:
    """Every leaf of the model: (name, shape, how it is drawn)."""
    d = cfg["d_model"]
    s, gn, conv_ch = _ssm_sizes(cfg)
    di, h, k = s["d_inner"], s["n_heads"], s["conv_kernel"]
    spec: Spec = [("embed.w", (cfg["padded_vocab"], d), ("normal", 0.02))]
    for i in range(cfg["n_layers"]):
        b = f"blocks.{i}."
        spec += [
            (b + "pre_norm.g", (d,), ("gain",)),
            (b + "mixer.in_proj.w", (d, 2 * di + 2 * gn + h),
             ("normal", d ** -0.5)),
            (b + "mixer.out_proj.w", (di, d), ("normal", di ** -0.5)),
            (b + "mixer.conv_w", (k, conv_ch), ("normal", k ** -0.5)),
            (b + "mixer.conv_b", (conv_ch,), ("bias",)),
            (b + "mixer.a_log", (h,), ("a_log",)),
            (b + "mixer.dt_bias", (h,), ("dt_bias",)),
            (b + "mixer.d_skip", (h,), ("gain",)),
            (b + "mixer.norm.g", (di,), ("gain",)),
        ]
    spec.append(("final_norm.g", (d,), ("gain",)))
    return spec


def mixer(p: Params, pre: str, cfg: dict, u: torch.Tensor,
          prec: Precision) -> torch.Tensor:
    """The Mamba2 mixer of block ``pre`` on u (B, S, d)."""
    s, gn, _ = _ssm_sizes(cfg)
    di, h, hd = s["d_inner"], s["n_heads"], s["head_dim"]
    b, n = u.shape[0], u.shape[1]
    proj = prec.mm(u, p[pre + "in_proj.w"])
    z, xbc, dt = proj[..., :di], proj[..., di:2 * di + 2 * gn], \
        proj[..., 2 * di + 2 * gn:]
    xbc = F.silu(causal_conv(xbc, p[pre + "conv_w"], p[pre + "conv_b"]))
    x = xbc[..., :di].reshape(b, n, h, hd)
    bmat = xbc[..., di:di + gn].reshape(b, n, s["n_groups"], s["d_state"])
    cmat = xbc[..., di + gn:].reshape(b, n, s["n_groups"], s["d_state"])
    dt = F.softplus(dt + p[pre + "dt_bias"])
    a = -torch.exp(p[pre + "a_log"])
    y = ssd(x, dt, a, bmat, cmat, s["chunk"])
    y = y + x * p[pre + "d_skip"][:, None]
    y = rmsnorm(y.reshape(b, n, di) * F.silu(z), p[pre + "norm.g"],
                cfg["norm_eps"])
    return prec.mm(y, p[pre + "out_proj.w"])


def mamba_block(p: Params, i: int, cfg: dict, x: torch.Tensor,
                prec: Precision) -> torch.Tensor:
    pre = f"blocks.{i}."
    return x + mixer(p, pre + "mixer.", cfg,
                     rmsnorm(x, p[pre + "pre_norm.g"], cfg["norm_eps"]), prec)


def forward(p: Params, cfg: dict, tokens: torch.Tensor,
            prec: Precision = Precision(), checkpoint: bool = False
            ) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, vocab), float32. ``checkpoint``
    recomputes each block in the backward pass to bound the memory."""
    x = p["embed.w"][tokens]
    for i in range(cfg["n_layers"]):
        x = maybe_checkpoint(
            lambda x, i=i: mamba_block(p, i, cfg, x, prec), x, checkpoint)
    h = rmsnorm(x, p["final_norm.g"], cfg["norm_eps"])
    return embed_logits(h, p["embed.w"], cfg["vocab"], prec)
