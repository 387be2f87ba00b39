"""Muon — the paper's A·Aᵀ·B expression in production, as the
reference's ``optim/muon.py``.

Muon (momentum + Newton–Schulz orthogonalization; Jordan et al. 2024)
post-processes each matrix's momentum M with the quintic iteration

    X ← a·X + b·(X Xᵀ)·X + c·(X Xᵀ)²·X

whose every step evaluates Gram-times-matrix products: the paper's
``A·Aᵀ·B`` (§3.2.2). Three associations are scored per weight shape by
the paper's discriminants (:func:`plan_ns_mode`):

  * ``gram``      — G = X Xᵀ as one triangle mirrored (SYRK), then G·X
    and G·(G·X) (SYMM);
  * ``gram_gemm`` — the same products as plain GEMMs;
  * ``right``     — K = XᵀX (k×k), then X·(b·K + c·K²).

The ``perfmodel`` score prices each call under the port's
:class:`AnalyticalHopperProfile` unless :func:`plan_ns_mode` is given a
``profile`` (the reference prices them under its TPU model; the port
keeps a copy of it, :class:`AnalyticalTPUProfile`). The iteration runs in bf16 as torch
tensor products: no hand kernel.

A leaf is a Muon matrix when the reference's leaf holding it is 2-D with
both sides at least 8 (:mod:`.leaves`): the tied embedding, the hybrid
family's shared block, and a layer stack's per-layer *vectors*, which
the reference stacks into (L, d) matrices (from 8 layers on). The
stack's matrices (the reference's (L, d_in, d_out) arrays) are 3-D there
and take AdamW, as every other leaf does. A stacked vector leaf is
orthogonalized as the reference's one (L, d) matrix, its layers stacked.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, NamedTuple, Optional

import torch

from repro_torch.core.flops import gemm as gemm_call, symm as symm_call, \
    syrk as syrk_call
from repro_torch.core.perfmodel import AnalyticalHopperProfile, KernelProfile

from . import adamw
from .leaves import group, reference_shape

# Quintic Newton–Schulz coefficients (Jordan et al.).
NS_COEFFS = (3.4445, -4.7750, 2.0315)
NS_STEPS = 5
NS_MODES = ("gram", "gram_gemm", "right")


def ns_algorithm_calls(mode: str, m: int, k: int):
    """Kernel-call bags for one NS iteration on an (m, k) matrix."""
    if mode == "gram":
        # G = X Xᵀ (syrk-able), A = G X (symm-able), B = G A
        return [syrk_call(m, k), symm_call(m, k), symm_call(m, k)]
    if mode == "gram_gemm":
        return [gemm_call(m, m, k), gemm_call(m, k, m), gemm_call(m, k, m)]
    if mode == "right":
        # K = Xᵀ X (k×k, syrk-able in transpose), then X·K, X·K²
        return [syrk_call(k, m), symm_call(k, m), gemm_call(k, k, k),
                gemm_call(m, k, k)]
    raise ValueError(mode)


def plan_ns_mode(m: int, k: int, discriminant: str = "perfmodel",
                 profile: Optional[KernelProfile] = None) -> str:
    """Pick the NS association per weight shape (the paper's selection)."""
    prof = profile or AnalyticalHopperProfile()
    scores = {}
    for mode in NS_MODES:
        calls = ns_algorithm_calls(mode, m, k)
        if discriminant == "flops":
            scores[mode] = sum(c.flops for c in calls)
        else:
            scores[mode] = sum(prof.time(c, 2) for c in calls)
    return min(scores, key=scores.get)


def _ns_iteration_gram(x: torch.Tensor, use_symmetry: bool) -> torch.Tensor:
    a, b, c = NS_COEFFS
    if use_symmetry:
        # The SYRK/SYMM realization: one triangle of G, mirrored.
        gl = torch.tril(x @ x.T)
        g = gl + torch.tril(gl, -1).T
    else:
        g = x @ x.T
    gx = g @ x
    return a * x + b * gx + c * (g @ gx)


def _ns_iteration_right(x: torch.Tensor) -> torch.Tensor:
    a, b, c = NS_COEFFS
    k = x.T @ x
    k2 = k @ k
    return a * x + x @ (b * k + c * k2)


def newton_schulz(x: torch.Tensor, steps: int = NS_STEPS, mode: str = "auto",
                  discriminant: str = "perfmodel") -> torch.Tensor:
    """Orthogonalize via quintic NS in bf16 (Muon's recipe), transposed so
    that m ≤ k, with the association chosen by the LAMP discriminant per
    shape unless ``mode`` names one."""
    m, k = x.shape
    transpose = m > k
    if transpose:
        x = x.T
        m, k = k, m
    if mode == "auto":
        mode = plan_ns_mode(m, k, discriminant)
    xf = x.to(torch.bfloat16)
    norm = torch.linalg.vector_norm(xf.float()) + 1e-7
    xf = (xf.float() / norm).to(torch.bfloat16)
    for _ in range(steps):
        if mode in ("gram", "gram_gemm"):
            xf = _ns_iteration_gram(xf, use_symmetry=(mode == "gram"))
        else:
            xf = _ns_iteration_right(xf)
    out = xf.to(x.dtype)
    return out.T if transpose else out


class MuonState(NamedTuple):
    step: torch.Tensor   # 0-d int32 on the device
    momentum: Dict[str, Optional[torch.Tensor]]  # fp32, matrices only
    adamw: adamw.AdamWState  # every leaf; applied to the non-matrix ones


def matrices(params: Mapping[str, torch.Tensor]) -> Dict[str, List[str]]:
    """The Muon matrices: reference name → the port's names holding it."""
    out = {}
    for key, names in group(params).items():
        shape = reference_shape(names[0], params[names[0]], len(names))
        if len(shape) == 2 and min(shape) >= 8:
            out[key] = names
    return out


def partition(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """Label the leaves: True → Muon, False → AdamW."""
    muon = {n for names in matrices(params).values() for n in names}
    return {n: n in muon for n in params}


def init(params: Mapping[str, torch.Tensor]) -> MuonState:
    labels = partition(params)
    mom = {n: torch.zeros_like(p, dtype=torch.float32) if labels[n] else None
           for n, p in params.items()}
    aw = adamw.init(params)
    return MuonState(step=adamw.counter(aw.step.device), momentum=mom,
                     adamw=aw)


def _stacked(tree: Mapping[str, torch.Tensor], names: List[str]
             ) -> torch.Tensor:
    return tree[names[0]] if len(names) == 1 else \
        torch.stack([tree[n] for n in names])


@torch.no_grad()
def update(grads: Mapping[str, torch.Tensor], state: MuonState,
           params: Mapping[str, torch.Tensor], lr,
           momentum: float = 0.95, weight_decay: float = 0.0,
           adamw_lr_scale: float = 0.3, ns_mode: str = "auto",
           discriminant: str = "perfmodel") -> MuonState:
    """One Muon step in place; returns ``state``, one step on. The AdamW
    branch updates both moments of every leaf (as the reference's does)
    and the non-matrix parameters; each matrix takes the orthogonalized
    Nesterov momentum, scaled by √max(1, rows/cols). Every parameter,
    momentum, moment and counter is written in place, and ``lr`` may be
    a 0-d tensor: the step reads nothing on the host (the Newton–Schulz
    association is a host decision per shape), so a CUDA graph can
    replay it."""
    aw_state = adamw.moments(grads, state.adamw)
    mats = matrices(params)
    muon_names = {n for names in mats.values() for n in names}
    adamw.apply(params, [n for n in params if n not in muon_names], aw_state,
                lr * adamw_lr_scale, weight_decay=weight_decay)
    for names in mats.values():
        p = _stacked(params, names)
        gf = _stacked(grads, names).float()
        mnew = _stacked(state.momentum, names).mul_(momentum).add_(gf)
        upd = newton_schulz(momentum * mnew + gf, mode=ns_mode,
                            discriminant=discriminant)
        scale = math.sqrt(max(1.0, p.shape[0] / p.shape[1]))
        pn = p - (lr * scale) * upd.float()
        if weight_decay > 0:
            pn = pn - (lr * weight_decay) * p
        if len(names) == 1:
            p.copy_(pn)
            continue
        for i, n in enumerate(names):
            params[n].copy_(pn[i])
            state.momentum[n].copy_(mnew[i])
    state.step.add_(1)
    return state
