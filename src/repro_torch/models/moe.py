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
reference, which computes them outside any Pallas kernel.

Inside :func:`repro_torch.sharding.context.activation_sharding` the
tokens and the dispatch groups run sharded over the data axes
(``shard_tokens_hidden``, ``shard_moe_groups``), the index plumbing on
each rank's own groups (``local_map``), and the expert products on
DTensors with the experts over ``model``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.sharding.context import (batch_axes, grad_in_layout,
                                          placements_of,
                                          shard_moe_groups,
                                          shard_tokens_hidden, whole_within)

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
        self.router = Dense(d, e, ("embed", "experts"), generator=generator,
                            device=device, dtype=dtype)
        self.w_gate = _normal(generator, (e, d, f), d ** -0.5, device, dtype)
        self.w_up = _normal(generator, (e, d, f), d ** -0.5, device, dtype)
        self.w_down = _normal(generator, (e, f, d), f ** -0.5, device, dtype)
        self.param_axes = {"w_gate": ("experts", "embed", "ffn"),
                           "w_up": ("experts", "embed", "ffn"),
                           "w_down": ("experts", "ffn", "embed")}


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
    ce = _expert_counts(gate_idx, e) / (nt * k)
    aux = e * torch.sum(me * ce)
    return gate_vals, gate_idx, aux


def _counts(idx: torch.Tensor, e: int) -> torch.Tensor:
    ce = torch.zeros(e, dtype=torch.float32, device=idx.device)
    ce.index_add_(0, idx.reshape(-1),
                  torch.ones(idx.numel(), dtype=torch.float32,
                             device=idx.device))
    return ce


def _expert_counts(idx: torch.Tensor, e: int) -> torch.Tensor:
    """Assignments per expert of the (T, k) expert ids ``idx``, float32.
    On a DTensor each rank counts its own tokens and the counts stay a
    partial sum over the axes the tokens are sharded on."""
    if not isinstance(idx, DTensor):
        return _counts(idx, e)
    mesh = idx.device_mesh
    ip = list(placements_of(mesh, idx.shape, (batch_axes(), None)))
    out = [Partial() if isinstance(pl, Shard) else Replicate() for pl in ip]
    return local_map(lambda i: _counts(i, e), out_placements=out,
                     in_placements=(ip,), device_mesh=mesh,
                     redistribute_inputs=True)(idx)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` (int64) as a comparison with ``arange(n)``:
    ``one_hot`` checks its indices on the host (``.item()``) on the CPU,
    and the decode step reads nothing on the host on any device."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


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
    w_gate, w_up, w_down = (w.to(dt) for w in (p.w_gate, p.w_up, p.w_down))
    if isinstance(xe, DTensor):
        xe, w_gate, w_up, w_down = _expert_parallel(xe, w_gate, w_up,
                                                    w_down)
    h = _act(cfg)(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    return torch.bmm(h, w_down)


def _expert_parallel(xe: DTensor, *weights: DTensor):
    """Expert parallelism: the experts over ``model`` (where it divides
    them), each rank's expert inputs keeping their rows' data sharding,
    and each expert's matrices whole on its rank (the FSDP gather over
    the data axes). Left to itself DTensor gathers every expert's weights
    on every rank instead."""
    mesh = xe.device_mesh
    ep = placements_of(mesh, xe.shape[:1], ("model",))
    x_pl = [e if isinstance(e, Shard) else pl
            for e, pl in zip(ep, xe.placements)]
    return (xe.redistribute(mesh, x_pl),
            *(w.redistribute(mesh, ep) for w in weights))


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
    onehot_flat = _one_hot(flat_idx, e)                         # (T*k, E)
    pos = _positions(onehot_flat, flat_idx)                     # (T*k,)
    keep = pos < cap
    gate_flat = gate_vals.reshape(-1) * keep.float()

    pos_oh = _one_hot(torch.where(keep, pos, cap), cap + 1
                      ).to(x.dtype)[..., :cap]                  # (T*k, cap)
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

def _dispatch(xg: torch.Tensor, eidx: torch.Tensor, e: int, cap: int):
    """Tokens (g, tg, d) and their experts (g, tg, k) → (expert inputs
    (E, g·cap, d) token-major, slot (g, tg·k), keep (g, tg·k))."""
    g, tg, d = xg.shape
    k = eidx.shape[2]
    dev = xg.device
    # positions within expert per group: cumsum over flattened (tg*k)
    ef = eidx.reshape(g, tg * k)
    pos = _positions(_one_hot(ef, e), ef)                       # (g, tg*k)
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
    return xe, slot, keep


def _combine(ye: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gval: torch.Tensor, cap: int) -> torch.Tensor:
    """Expert outputs (E, g·cap, d) → per-token outputs (g, tg, d): each
    (token, choice) gathers its slot's output, weighed by its gate."""
    e, _, d = ye.shape
    g, tg, k = gval.shape
    ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    safe_slot = torch.where(keep, slot, 0)
    y_tk = torch.gather(ye, 1, safe_slot[:, :, None].expand(g, tg * k, d))
    y_tk = y_tk * keep[:, :, None].to(y_tk.dtype)              # (g,tg*k,d)
    y_tk = y_tk.reshape(g, tg, k, d) * gval[..., None].to(y_tk.dtype)
    return y_tk.sum(dim=2)                                     # (g, tg, d)


def _sharded_index_ops(xg: DTensor, e: int, cap: int):
    """:func:`_dispatch` and :func:`_combine` on each rank's groups
    (``local_map``): the index plumbing has no DTensor sharding rule. The
    groups stay sharded over the batch axes (``shard_moe_groups``); the
    expert products between the two run on DTensors, experts over
    ``model``, and the combine gathers every expert's outputs for its
    groups."""
    mesh = xg.device_mesh
    gp = list(placements_of(mesh, xg.shape[:1], (batch_axes(),)))
    ep = [Shard(1) if isinstance(pl, Shard) else pl for pl in gp]
    dispatch = local_map(lambda x, i: _dispatch(x, i, e, cap),
                         out_placements=(ep, gp, gp), in_placements=(gp, gp),
                         device_mesh=mesh, redistribute_inputs=True)
    combine = local_map(lambda y, s, k, v: _combine(y, s, k, v, cap),
                        out_placements=gp, in_placements=(ep, gp, gp, gp),
                        device_mesh=mesh, redistribute_inputs=True)
    return dispatch, combine


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

    xt = shard_tokens_hidden(whole_within(x, 0, 1).reshape(nt, d))
    gate_vals, gate_idx, aux = _route(p, cfg, xt)
    if isinstance(xt, DTensor):
        # whole groups on each rank (replicated when g does not divide)
        mesh = xt.device_mesh
        gp = placements_of(mesh, (g,), (batch_axes(),))
        xt, gate_vals, gate_idx = (t.redistribute(mesh, gp) for t in
                                   (xt, gate_vals, gate_idx))

    xg = shard_moe_groups(xt.reshape(g, tg, d))
    eidx = gate_idx.reshape(g, tg, k)
    gval = gate_vals.reshape(g, tg, k)
    dispatch = lambda x, i: _dispatch(x, i, e, cap)            # noqa: E731
    combine = lambda y, s, k, v: _combine(y, s, k, v, cap)     # noqa: E731
    if isinstance(xg, DTensor):
        dispatch, combine = _sharded_index_ops(xg, e, cap)
    xe, slot, keep = dispatch(xg, eidx)
    ye = _experts(p, cfg, xe)                                  # (E,g*cap,d)
    yg = combine(ye, slot, keep, gval)
    return grad_in_layout(yg.reshape(b, s, d)).to(x.dtype), aux


def apply(p: MoE, cfg: MoEConfig, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (output, aux_loss)."""
    if cfg.dispatch == "einsum":
        return _apply_einsum(p, cfg, x)
    return _apply_gather(p, cfg, x)
