"""The ``hybrid`` family's reference: Zamba2 (arXiv:2411.15242) with its
published shared block, in plain float32 PyTorch.

A model is a dict of tensors keyed by parameter name and the
configuration dict of ``h100_bench/configs/<name>.json``. With x₀ the
token embedding and x = x₀, for each Mamba2 layer i: where i is the a-th
of ``shared.hybrid_layer_ids``, memory block b = a mod
``shared.num_mem_blocks`` computes

    u = rmsnorm([x, x₀])                       (2·d_model wide)
    q, k, v = W·u + B_a·(A_a·u)                (adapters with attn_adapters)
    o = W_o · softmax(causal(RoPE(q)·RoPE(k)ᵀ · (head_dim / 2)^-½)) · v
    h = rmsnorm(o)
    [g, up] = W_gu·h + B_a·(A_a·h)
    t = L_a · W_down(gelu(g) ⊙ up)             (the exact, erf GELU)

and the layer is x ← x + mamba_i(rmsnorm(x + t)); elsewhere x ← x +
mamba_i(rmsnorm(x)). Then the final rmsnorm and the tied head. The Mamba2
mixer is ``reference/ssm.py``'s. RoPE rotates the two halves of each head
(``transformers``' ``rotate_half``) with θ = ``shared.rope_theta``.

The equations are those of ``transformers``' ``Zamba2HybridLayer``,
``Zamba2AttentionDecoderLayer``, ``Zamba2Attention`` and ``Zamba2MLP``
(read, not imported). Departures from that code:

* the RMSNorm epsilon is the configuration's ``norm_eps`` (the program's
  1e-6; ``reduced``), where the model has 1e-5;
* k's and v's adapters end at ``n_kv_heads``·``head_dim``, the width of
  k and v; ``transformers`` ends them at the attention's input width,
  which is the same number when, as here, the heads are not grouped;
* the embedding has no padding row: ``transformers`` zeroes the gradient
  of row ``pad_token_id`` (0), and here token 0 is an ordinary token;
* no dropout, no cache, no attention mask beyond the causal one.

The names are those of the benchmark's weights (``param_spec``); the
harness hands the same tensors to the program under those names.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from . import ssm as ssm_ref
from .common import Precision, embed_logits, maybe_checkpoint, rmsnorm

Params = Dict[str, torch.Tensor]


def param_spec(cfg: dict) -> ssm_ref.Spec:
    """Every leaf of the model: (name, shape, how it is drawn)."""
    d, sh = cfg["d_model"], cfg["shared"]
    din, r, dff = 2 * d, sh["adapter_rank"], sh["d_ff"]
    hq = sh["n_heads"] * sh["head_dim"]
    hkv = sh["n_kv_heads"] * sh["head_dim"]
    spec = [s for s in ssm_ref.param_spec(cfg) if s[0] != "final_norm.g"]
    for b in range(sh["num_mem_blocks"]):
        m = f"mem_blocks.{b}."
        spec += [
            (m + "input_norm.g", (din,), ("gain",)),
            (m + "attn.wq.w", (din, hq), ("normal", din ** -0.5)),
            (m + "attn.wk.w", (din, hkv), ("normal", din ** -0.5)),
            (m + "attn.wv.w", (din, hkv), ("normal", din ** -0.5)),
            (m + "attn.wo.w", (hq, d), ("normal", hq ** -0.5)),
            (m + "pre_ff_norm.g", (d,), ("gain",)),
            (m + "gate_up.w", (d, 2 * dff), ("normal", d ** -0.5)),
            (m + "down.w", (dff, d), ("normal", dff ** -0.5)),
        ]
    adapters = [("gate_up", d, 2 * dff)]
    if sh["attn_adapters"]:
        adapters = [("q", din, hq), ("k", din, hkv), ("v", din, hkv)] \
            + adapters
    for a in range(len(sh["hybrid_layer_ids"])):
        pre = f"applications.{a}."
        for name, d_in, d_out in adapters:
            spec += [(f"{pre}{name}.a.w", (d_in, r), ("normal", d_in ** -0.5)),
                     (f"{pre}{name}.b.w", (r, d_out), ("normal", 0.02))]
        spec.append((pre + "linear.w", (d, d), ("normal", d ** -0.5)))
    spec.append(("final_norm.g", (d,), ("gain",)))
    return spec


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh) rotated by position: the halves (x₁, x₂) of each
    head become (x₁·cos − x₂·sin, x₂·cos + x₁·sin) at angles
    position · θ^(−2j/Dh)."""
    s, dh = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float32,
                                  device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, prec: Precision) -> torch.Tensor:
    """Causal softmax attention, q (B, S, H, Dh), k / v (B, S, Hkv, Dh)
    → (B, S, H·Dh)."""
    b, s, h, dh = q.shape
    rep = h // k.shape[2]
    k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", prec.round(q),
                          prec.round(k)) * scale
    future = torch.triu(torch.ones(s, s, dtype=torch.bool, device=q.device),
                        diagonal=1)
    probs = torch.softmax(logits.masked_fill(future, -math.inf), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", prec.round(probs), prec.round(v))
    return out.reshape(b, s, h * dh)


def _adapter(p: Params, pre: str, x: torch.Tensor,
             prec: Precision) -> torch.Tensor:
    return prec.mm(prec.mm(x, p[pre + ".a.w"]), p[pre + ".b.w"])


def shared_block(p: Params, cfg: dict, a: int, x: torch.Tensor,
                 x0: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Application ``a`` of the shared block → t (B, S, d_model)."""
    sh, eps = cfg["shared"], cfg["norm_eps"]
    m = f"mem_blocks.{a % sh['num_mem_blocks']}."
    ap = f"applications.{a}."
    b, s, _ = x.shape
    u = rmsnorm(torch.cat([x, x0], dim=-1), p[m + "input_norm.g"], eps)
    q, k, v = (prec.mm(u, p[m + f"attn.w{n}.w"]) for n in "qkv")
    if sh["attn_adapters"]:
        q = q + _adapter(p, ap + "q", u, prec)
        k = k + _adapter(p, ap + "k", u, prec)
        v = v + _adapter(p, ap + "v", u, prec)
    dh = sh["head_dim"]
    q = rope(q.reshape(b, s, sh["n_heads"], dh), sh["rope_theta"])
    k = rope(k.reshape(b, s, sh["n_kv_heads"], dh), sh["rope_theta"])
    v = v.reshape(b, s, sh["n_kv_heads"], dh)
    o = prec.mm(attention(q, k, v, (dh / 2) ** -0.5, prec),
                p[m + "attn.wo.w"])
    h = rmsnorm(o, p[m + "pre_ff_norm.g"], eps)
    gu = prec.mm(h, p[m + "gate_up.w"]) + _adapter(p, ap + "gate_up", h,
                                                    prec)
    g, up = gu.chunk(2, dim=-1)
    mlp = prec.mm(F.gelu(g) * up, p[m + "down.w"])
    return prec.mm(mlp, p[ap + "linear.w"])


def layer(p: Params, cfg: dict, i: int, apps: Dict[int, int],
          x: torch.Tensor, x0: torch.Tensor, prec: Precision
          ) -> torch.Tensor:
    """Mamba2 layer ``i``, fed by its application of the shared block
    where it has one."""
    pre = f"blocks.{i}."
    fed = x + shared_block(p, cfg, apps[i], x, x0, prec) if i in apps \
        else x
    return x + ssm_ref.mixer(p, pre + "mixer.", cfg,
                             rmsnorm(fed, p[pre + "pre_norm.g"],
                                     cfg["norm_eps"]), prec)


def forward(p: Params, cfg: dict, tokens: torch.Tensor,
            prec: Precision = Precision(), checkpoint: bool = False
            ) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, vocab), float32. ``checkpoint``
    recomputes each layer, with its application of the shared block, in
    the backward pass to bound the memory."""
    ids: List[int] = cfg["shared"]["hybrid_layer_ids"]
    apps = {layer_id: a for a, layer_id in enumerate(ids)}
    x0 = p["embed.w"][tokens]
    x = x0
    for i in range(cfg["n_layers"]):
        x = maybe_checkpoint(
            lambda x, i=i: layer(p, cfg, i, apps, x, x0, prec), x,
            checkpoint)
    h = rmsnorm(x, p["final_norm.g"], cfg["norm_eps"])
    return embed_logits(h, p["embed.w"], cfg["vocab"], prec)
