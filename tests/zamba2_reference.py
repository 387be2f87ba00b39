"""A plain float32 reference of Zamba2 (arXiv:2411.15242) with its
published shared block, for the CPU tests of the port's
``shared_block="published"`` layout. It imports no package of this
repository, nor JAX or ``transformers``; the tests hand it the port's
weights by parameter name and its configuration as a dict (:func:`spec`).

With x₀ the token embedding and x = x₀, each Mamba2 layer i that is the
a-th of ``hybrid_layer_ids`` is fed by memory block a mod
``num_mem_blocks``:

    u = rmsnorm([x, x₀])
    q, k, v = W·u + B_a·(A_a·u)               (with attn_adapters)
    o = W_o · softmax(causal(RoPE(q)·RoPE(k)ᵀ) · (head_dim / 2)^-½) · v
    [g, up] = W_gu·rmsnorm(o) + B_a·(A_a·rmsnorm(o))
    t = L_a · W_down(gelu(g) ⊙ up)
    x ← x + mamba_i(rmsnorm(x + t))

and every other layer is x ← x + mamba_i(rmsnorm(x)); then the final
rmsnorm and the tied head. The Mamba2 mixer's SSD is written in its
whole-sequence quadratic form, y = (L ∘ C·Bᵀ)·(Δt·x) with
L[t, s] = exp(Σ_{s<k≤t} Δt_k·a), not in chunks.

The equations are those of ``transformers``' ``modeling_zamba2.py``
(``Zamba2HybridLayer``, ``Zamba2AttentionDecoderLayer``,
``Zamba2Attention``, ``Zamba2MLP``), read and not imported. Departures:
the RMSNorm epsilon is the port's 1e-6 (the model's 1e-5); k's and v's
adapters end at n_kv_heads·head_dim (``transformers`` ends them at the
attention's input width, the same number when the heads are not
grouped); no padding row in the embedding; no dropout or cache.

``gelu`` ("none", the exact GELU, or "tanh") and ``scale`` (the logits'
scale; the published (head_dim / 2)^-½ by default) exist so that a test
can show that its tolerance tells them apart; ``mem_grad_from`` (the
applications through which the memory blocks' weights take a gradient;
all by default) so that a test can split the shared weights' gradient by
application.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Set

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
EPS = 1e-6


def spec(cfg) -> dict:
    """The sizes this reference reads, from a port ModelConfig-like
    object (attributes only)."""
    s = cfg.ssm
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab, "d_inner": s.d_inner, "ssm_heads": s.n_heads,
            "ssm_head_dim": s.head_dim, "groups": s.n_groups,
            "d_state": s.d_state, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "rope_theta": cfg.rope_theta, "num_mem_blocks": cfg.num_mem_blocks,
            "hybrid_layer_ids": list(cfg.hybrid_layer_ids),
            "attn_adapters": cfg.attn_adapters}


def rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * g


def mamba(p: Params, pre: str, c: dict, u: torch.Tensor) -> torch.Tensor:
    """The Mamba2 mixer of layer ``pre`` on u (B, S, d)."""
    b, s, _ = u.shape
    di, h, hd = c["d_inner"], c["ssm_heads"], c["ssm_head_dim"]
    gn = c["groups"] * c["d_state"]
    proj = u @ p[pre + "in_proj.w"]
    z, xbc, dt = proj[..., :di], proj[..., di:2 * di + 2 * gn], \
        proj[..., 2 * di + 2 * gn:]
    w, bias = p[pre + "conv_w"], p[pre + "conv_b"]
    k = w.shape[0]
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    xbc = F.silu(bias + sum(padded[:, i:i + s] * w[i] for i in range(k)))
    x = xbc[..., :di].reshape(b, s, h, hd)
    rep = h // c["groups"]
    bm = xbc[..., di:di + gn].reshape(b, s, c["groups"], -1) \
        .repeat_interleave(rep, 2)
    cm = xbc[..., di + gn:].reshape(b, s, c["groups"], -1) \
        .repeat_interleave(rep, 2)
    dt = F.softplus(dt + p[pre + "dt_bias"])                  # (B, S, H)
    a = -torch.exp(p[pre + "a_log"])
    cum = torch.cumsum(dt * a, dim=1)                         # (B, S, H)
    diff = cum[:, :, None, :] - cum[:, None, :, :]            # (B, t, s, H)
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool))[None, :, :, None]
    decay = torch.exp(diff.masked_fill(~causal, -math.inf))
    scores = torch.einsum("bthn,bshn->btsh", cm, bm) * decay
    y = torch.einsum("btsh,bshp->bthp", scores, x * dt[..., None])
    y = y + x * p[pre + "d_skip"][:, None]
    y = rmsnorm(y.reshape(b, s, di) * F.silu(z), p[pre + "norm.g"])
    return y @ p[pre + "out_proj.w"]


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh), each head's halves rotated by position."""
    s, dh = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float32) / dh)
    ang = torch.arange(s, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def shared_block(p: Params, c: dict, a: int, x: torch.Tensor,
                 x0: torch.Tensor, gelu: str = "none",
                 scale: Optional[float] = None,
                 mem_grad_from: Optional[Set[int]] = None) -> torch.Tensor:
    """Application ``a`` → t (B, S, d)."""
    m = f"mem_blocks.{a % c['num_mem_blocks']}."
    ap = f"applications.{a}."

    def mem(name):
        w = p[m + name]
        return w if mem_grad_from is None or a in mem_grad_from \
            else w.detach()

    def adapter(name, v):
        return v @ p[ap + name + ".a.w"] @ p[ap + name + ".b.w"]

    b, s, _ = x.shape
    dh, h, hkv = c["head_dim"], c["n_heads"], c["n_kv_heads"]
    u = rmsnorm(torch.cat([x, x0], dim=-1), mem("input_norm.g"))
    q, k, v = (u @ mem(f"attn.w{n}.w") for n in "qkv")
    if c["attn_adapters"]:
        q, k, v = q + adapter("q", u), k + adapter("k", u), \
            v + adapter("v", u)
    q = rope(q.reshape(b, s, h, dh), c["rope_theta"])
    k = rope(k.reshape(b, s, hkv, dh), c["rope_theta"]) \
        .repeat_interleave(h // hkv, 2)
    v = v.reshape(b, s, hkv, dh).repeat_interleave(h // hkv, 2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * \
        (scale if scale is not None else (dh / 2) ** -0.5)
    future = torch.triu(torch.ones(s, s, dtype=torch.bool), diagonal=1)
    probs = torch.softmax(logits.masked_fill(future, -math.inf), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * dh) \
        @ mem("attn.wo.w")
    hn = rmsnorm(o, mem("pre_ff_norm.g"))
    g, up = (hn @ mem("gate_up.w") + adapter("gate_up", hn)).chunk(2, -1)
    return (F.gelu(g, approximate=gelu) * up) @ mem("down.w") \
        @ p[ap + "linear.w"]


def forward(p: Params, c: dict, tokens: torch.Tensor, **shared
            ) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, vocab); ``shared`` goes to
    :func:`shared_block`."""
    apps = {i: a for a, i in enumerate(c["hybrid_layer_ids"])}
    x0 = p["embed.w"][tokens]
    x = x0
    for i in range(c["n_layers"]):
        pre = f"blocks.{i}."
        fed = x + shared_block(p, c, apps[i], x, x0, **shared) \
            if i in apps else x
        x = x + mamba(p, pre + "mixer.", c,
                      rmsnorm(fed, p[pre + "pre_norm.g"]))
    logits = rmsnorm(x, p["final_norm.g"]) @ p["embed.w"].t()
    return logits[..., :c["vocab"]]
