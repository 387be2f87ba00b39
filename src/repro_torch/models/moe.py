"""Mixture-of-Experts layer: top-k router + capacity-based dispatch.

Counterpart of the reference's ``models/moe.py``. Two dispatch
implementations, selectable via ``MoEConfig.dispatch``:

* ``gather`` (default) — GShard-style *grouped* dispatch with
  scatter/gather index plumbing: tokens are split into ``n_groups``
  groups; within each group capacity positions come from a local cumsum,
  and expert inputs/outputs move by gathers. Every intermediate is
  O(E·C_g·d) per group.
* ``einsum`` — the classic one-hot dispatch/combine einsums, the oracle
  the tests compare against. It builds (T·k, E, C) intermediates.

Tokens beyond an expert's per-group capacity are dropped; the router
adds the usual load-balancing auxiliary loss. The expert products
(``ecd,edf->ecf``) are plain batched matrix products, as in the
reference, which computes them outside any Pallas kernel. The
reference's ``shard_moe_groups`` is the identity outside a mesh and is
left out (ROADMAP A9).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, _normal, dense, gelu


class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int               # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    activation: str = "silu"
    dispatch: str = "gather"     # gather | einsum
    group_size: int = 4096       # tokens per dispatch group (gather mode)


class MoE(nn.Module):
    """``router`` (d, E) ~ N(0, 1/d); ``w_gate``/``w_up`` (E, d, f) ~
    N(0, 1/d); ``w_down`` (E, f, d) ~ N(0, 1/f)."""

    def __init__(self, cfg: MoEConfig, *, generator, device, dtype):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = Dense(d, e, generator=generator, device=device,
                            dtype=dtype)
        self.w_gate = _normal(generator, (e, d, f), d ** -0.5, device, dtype)
        self.w_up = _normal(generator, (e, d, f), d ** -0.5, device, dtype)
        self.w_down = _normal(generator, (e, f, d), f ** -0.5, device, dtype)


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(cap, 1)


def _route(p: MoE, cfg: MoEConfig, xt: torch.Tensor):
    """Shared router: returns (gate_vals (T,k), gate_idx (T,k), aux).
    ``torch.topk`` returns a token's k distinct experts in descending
    order, as ``lax.top_k`` does, so the per-expert positions below are
    the reference's."""
    e, k = cfg.n_experts, cfg.top_k
    nt = xt.shape[0]
    logits = dense(p.router, xt).float()                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)          # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=xt.device)
    ce.index_add_(0, gate_idx.reshape(-1),
                  torch.ones(nt * k, dtype=torch.float32, device=xt.device))
    ce = ce / (nt * k)
    aux = e * torch.sum(me * ce)
    return gate_vals, gate_idx, aux


def _positions(onehot: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Position of each assignment among its expert's, in order:
    ``onehot`` (..., A, E) of the ``idx`` (..., A) → (..., A). The running
    count runs along the last dimension of the transposed one-hot: on
    CUDA a scan along an outer dimension of a few dozen columns is far
    slower (it took most of OLMoE's prefill on an H100)."""
    counts = torch.cumsum(onehot.transpose(-1, -2).contiguous(), dim=-1)
    return torch.gather(counts, -2, idx.unsqueeze(-2)).squeeze(-2) - 1


def _act(cfg: MoEConfig):
    return F.silu if cfg.activation == "silu" else gelu


def _experts(p: MoE, cfg: MoEConfig, xe: torch.Tensor) -> torch.Tensor:
    """(E, C, d) expert inputs → (E, C, d) expert outputs."""
    dt = xe.dtype
    h = _act(cfg)(torch.bmm(xe, p.w_gate.to(dt))) \
        * torch.bmm(xe, p.w_up.to(dt))
    return torch.bmm(h, p.w_down.to(dt))


# ------------------------------------------------------ einsum dispatch ---

def _apply_einsum(p: MoE, cfg: MoEConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    nt = b * s
    xt = x.reshape(nt, d)
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, nt)
    gate_vals, gate_idx, aux = _route(p, cfg, xt)

    flat_idx = gate_idx.reshape(-1)                             # (T*k,)
    onehot_flat = F.one_hot(flat_idx, e)                        # (T*k, E)
    pos = _positions(onehot_flat, flat_idx)                     # (T*k,)
    keep = pos < cap
    gate_flat = gate_vals.reshape(-1) * keep.float()

    pos_oh = F.one_hot(torch.where(keep, pos, cap), cap + 1
                       ).to(x.dtype)[..., :cap]                 # (T*k, cap)
    disp = (onehot_flat.to(x.dtype)[:, :, None] * pos_oh[:, None, :]
            ).reshape(nt, k, e, cap).sum(dim=1)                 # (T,E,C)
    comb = (onehot_flat.float() * gate_flat[:, None])[:, :, None] \
        * pos_oh[:, None, :].float()
    comb = comb.reshape(nt, k, e, cap).sum(dim=1)               # (T,E,C)
    del pos_oh, onehot_flat

    xe = torch.einsum("td,tec->ecd", xt, disp)
    ye = _experts(p, cfg, xe)
    yt = torch.einsum("ecd,tec->td", ye.float(), comb)
    return yt.reshape(b, s, d).to(x.dtype), aux


# ------------------------------------------------------ gather dispatch ---

def _apply_gather(p: MoE, cfg: MoEConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped scatter/gather dispatch (GShard groups, zero-matmul)."""
    b, s, d = x.shape
    nt = b * s
    e, k = cfg.n_experts, cfg.top_k
    # group count: ~group_size tokens each, at least 1
    g = max(1, nt // max(cfg.group_size, 1))
    while nt % g:
        g -= 1
    tg = nt // g
    cap = capacity(cfg, tg)
    dev = x.device

    xt = x.reshape(nt, d)
    gate_vals, gate_idx, aux = _route(p, cfg, xt)

    xg = xt.reshape(g, tg, d)
    eidx = gate_idx.reshape(g, tg, k)
    gval = gate_vals.reshape(g, tg, k)

    # positions within expert per group: cumsum over flattened (tg*k)
    ef = eidx.reshape(g, tg * k)
    pos = _positions(F.one_hot(ef, e), ef)                      # (g, tg*k)
    keep = pos < cap
    # slot id within group: e*cap + pos; dropped → the overflow slot e*cap
    slot = torch.where(keep, ef * cap + pos, e * cap)           # (g, tg*k)

    # scatter token index into slots: slot_src[g, slot] = token idx + 1.
    # Kept (expert, position) pairs are distinct, so every slot below
    # e*cap is written once; the overflow slot takes duplicates in any
    # order and is sliced off before any read.
    tok_local = (torch.arange(tg * k, device=dev) // k).expand(g, tg * k)
    slot_src = torch.zeros((g, e * cap + 1), dtype=torch.long, device=dev)
    slot_src.scatter_(1, slot, tok_local + 1)
    occupied = slot_src[:, : e * cap] > 0                      # (g, E*cap)
    src = (slot_src[:, : e * cap] - 1).clamp_min(0)            # (g, E*cap)

    # gather expert inputs: (g, E*cap, d) → (E, g*cap, d) token-major
    xe = torch.gather(xg, 1, src[:, :, None].expand(g, e * cap, d))
    xe = xe * occupied[:, :, None].to(xe.dtype)
    xe = xe.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)

    ye = _experts(p, cfg, xe)                                  # (E,g*cap,d)
    ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)

    # combine: per (token, choice) gather its slot's output
    safe_slot = torch.where(keep, slot, 0)
    y_tk = torch.gather(ye, 1, safe_slot[:, :, None].expand(g, tg * k, d))
    y_tk = y_tk * keep[:, :, None].to(y_tk.dtype)              # (g,tg*k,d)
    y_tk = y_tk.reshape(g, tg, k, d) * gval[..., None].to(y_tk.dtype)
    yg = y_tk.sum(dim=2)                                       # (g, tg, d)
    return yg.reshape(b, s, d).to(x.dtype), aux


def apply(p: MoE, cfg: MoEConfig, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (output, aux_loss)."""
    if cfg.dispatch == "einsum":
        return _apply_einsum(p, cfg, x)
    return _apply_gather(p, cfg, x)
