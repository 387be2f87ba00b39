"""Training steps of the reference: cross-entropy, gradients by autograd,
global-norm clipping and AdamW, all in float32.

AdamW as the configurations state it (Loshchilov & Hutter, decoupled
weight decay): m ← β1·m + (1−β1)·g, v ← β2·v + (1−β2)·g², then
p ← p − lr·(m/(1−β1ᵗ) / (√(v/(1−β2ᵗ)) + ε) + λ·p), the decay on every
matrix and on every leaf of the layer stack (``blocks.*``), the gradients
first scaled to a global norm of at most ``grad_clip``. The learning rate
rises linearly from 0 over ``warmup`` steps and then follows a cosine to
``floor``·peak at ``total_steps``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from . import family
from .common import Precision, cross_entropy


def learning_rate(step: int, opt: dict) -> float:
    peak, warmup = opt["peak_lr"], opt["warmup"]
    if step < warmup:
        return peak * step / max(1, warmup)
    t = min(1.0, max(0.0, (step - warmup) / max(1, opt["total_steps"]
                                                  - warmup)))
    floor = opt["lr_floor"]
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * t)))


def decayed(name: str, shape: Sequence[int]) -> bool:
    return name.startswith("blocks.") or len(shape) >= 2


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].float())
                        for n in names]).tolist()
    return dict(zip(names, vals))


def run_steps(cfg: dict, params0: Dict[str, torch.Tensor],
              batches: List[Tuple[torch.Tensor, torch.Tensor]], opt: dict,
              prec: Precision = Precision(), checkpoint: bool = True
              ) -> dict:
    """``len(batches)`` steps from ``params0`` (left as they are) →
    {"losses": [...], "first_grad": {leaf: ‖clipped gradient of step 0‖},
    "change": {leaf: ‖p − p0‖ after the last step}}. With ``prec`` fp8
    (the control) the working copy and the inputs of every product are
    rounded to fp8; the masters, moments and update stay float32."""
    p = {n: t.detach().float().clone().requires_grad_(True)
         for n, t in params0.items()}
    names = list(p)
    m = {n: torch.zeros_like(p[n]) for n in names}
    v = {n: torch.zeros_like(p[n]) for n in names}
    b1, b2 = opt["b1"], opt["b2"]
    losses, first = [], None
    for k, (tokens, labels) in enumerate(batches):
        # the working copy: the leaves that the configuration computes in
        # bfloat16, rounded as ``prec`` says (the identity in float32)
        work = {n: prec.round(t) if decayed(n, t.shape) else t
                for n, t in p.items()}
        loss = cross_entropy(
            family(cfg).forward(work, cfg, tokens, prec, checkpoint), labels)
        del work
        grads = torch.autograd.grad(loss, [p[n] for n in names])
        losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            total = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.clamp(opt["grad_clip"] / torch.clamp(total,
                                                               min=1e-12),
                                max=1.0)
            grads = {n: g * scale for n, g in zip(names, grads)}
            if k == 0:
                first = norms(grads)
            lr, t = learning_rate(k, opt), k + 1
            for n in names:
                m[n].mul_(b1).add_(grads[n], alpha=1 - b1)
                v[n].mul_(b2).addcmul_(grads[n], grads[n], value=1 - b2)
                upd = (m[n] / (1 - b1 ** t)) / (
                    torch.sqrt(v[n] / (1 - b2 ** t)) + opt["eps"])
                if decayed(n, p[n].shape):
                    upd = upd + opt["weight_decay"] * p[n]
                p[n].sub_(lr * upd)
            del grads
    with torch.no_grad():
        change = norms({n: p[n] - params0[n].float() for n in names})
    return {"losses": losses, "first_grad": first, "change": change}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              leaves: Sequence[str]) -> Dict[str, float]:
    """|got − want| of each of ``leaves``, against the larger of its own
    reference norm and the median leaf's."""
    ref = sorted(want[n] for n in leaves)
    median = ref[len(ref) // 2]
    return {n: abs(got[n] - want[n]) / max(want[n], median, 1e-30)
            for n in leaves}


def worst_leaf(got: Dict[str, float], want: Dict[str, float],
               leaves: Sequence[str]) -> Tuple[float, str]:
    """The largest of :func:`leaf_gaps` → (gap, leaf)."""
    gaps = leaf_gaps(got, want, leaves)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moving_leaves(first_grad: Dict[str, float],
                  share: float = 1e-3) -> List[str]:
    """Leaves whose first reference gradient is at least ``share`` of the
    median leaf's: the others move under Adam by round-off alone."""
    vals = sorted(first_grad.values())
    median = vals[len(vals) // 2]
    return [n for n, g in first_grad.items() if g >= share * median]
