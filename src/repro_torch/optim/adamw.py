"""AdamW, as the reference's ``optim/adamw.py``.

Mixed-precision discipline: fp32 master params and fp32 moments whatever
the compute dtype; the train step differentiates a bf16 working copy.
Parameters, gradients and moments are dicts of tensors keyed by the
model's state-dict names. Where the reference returns new arrays, the
port updates the parameters and the moments in place (under
``torch.no_grad()``) and returns the new state: the train loop owns its
state, and a functional update would copy all of it every step. The
update runs as ``torch._foreach_*`` passes over all the leaves at once,
the way ``torch.optim``'s multi-tensor AdamW does.

The step counter is a 0-d int32 tensor on the parameters' device, the
reference's ``jnp.int32`` counter, advanced in place; the bias
corrections are computed from it on the device, and ``lr`` may be a 0-d
tensor (the schedule's), so that a step reads nothing on the host and a
CUDA graph can replay it.

Weight decay applies to the leaves whose reference leaf has rank 2 or
more (:func:`~repro_torch.optim.leaves.reference_ndim`): every weight
matrix, and also the per-layer vectors of a layer stack, which the
reference stacks into (L, d) arrays.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, NamedTuple, Tuple

import torch

from repro_torch.runtime import spans

from .leaves import reference_ndim

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32 on the device
    mu: Tree
    nu: Tree


def counter(device=None) -> torch.Tensor:
    """A step counter at 0: a 0-d int32 tensor on ``device``."""
    return torch.zeros((), dtype=torch.int32, device=device)


def init(params: Mapping[str, torch.Tensor]) -> AdamWState:
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.items()}
    device = next(iter(params.values())).device if params else None
    return AdamWState(step=counter(device), mu=zeros,
                      nu={n: z.clone() for n, z in zeros.items()})


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """√Σ g² over every leaf, each summed in float32."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in grads]
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def moments(grads: Mapping[str, torch.Tensor], state: AdamWState,
            b1: float = 0.9, b2: float = 0.95,
            grad_clip: float = 1.0) -> AdamWState:
    """Both moments of every leaf from the fp32 gradients, clipped to a
    global norm of ``grad_clip`` (none when it is 0), and the step
    counter, in place; returns ``state``, now one step on. Spans
    ``adamw.moments``, with ``adamw.cast`` and ``adamw.clip`` inside."""
    with spans.span("adamw.moments"):
        names = list(grads)
        with spans.span("adamw.cast"):
            gf = [grads[n].float() for n in names]
        if grad_clip > 0:
            with spans.span("adamw.clip"):
                gnorm = global_norm(gf)
                scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                                    max=1.0)
                gf = torch._foreach_mul(gf, scale)
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, gf, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, gf, gf, value=1 - b2)
        state.step.add_(1)
    return state


@torch.no_grad()
def apply(params: Mapping[str, torch.Tensor], names: Iterable[str],
          state: AdamWState, lr, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> None:
    """p ← p − lr·(m̂ / (√v̂ + eps) + wd·p) for the leaves ``names``, in
    place, from ``state``'s moments (already at its ``step``); ``lr`` is
    a float or a 0-d tensor. Span ``adamw.apply``."""
    names = list(names)
    if not names:
        return
    with spans.span("adamw.apply"):
        bc1, bc2 = bias_corrections(state.step, b1, b2)
        mhat = torch._foreach_div([state.mu[n] for n in names], bc1)
        denom = torch._foreach_div([state.nu[n] for n in names], bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(mhat, denom)
        del denom
        decayed = [i for i, n in enumerate(names)
                   if reference_ndim(n, params[n]) >= 2]
        if weight_decay and decayed:
            torch._foreach_add_([mhat[i] for i in decayed],
                                [params[names[i]] for i in decayed],
                                alpha=weight_decay)
        torch._foreach_mul_(mhat, lr)
        torch._foreach_sub_([params[n] for n in names], mhat)


def bias_corrections(step: torch.Tensor, b1: float = 0.9, b2: float = 0.95
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1 − b1^step, 1 − b2^step) in float32 on the counter's device, as
    the reference computes them."""
    s = step.to(torch.float32)
    return 1 - torch.pow(b1, s), 1 - torch.pow(b2, s)


def update(grads: Mapping[str, torch.Tensor], state: AdamWState,
           params: Mapping[str, torch.Tensor], lr, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           grad_clip: float = 1.0) -> AdamWState:
    """One AdamW step on every leaf of ``params`` in place (global-norm
    clipping included); returns ``state``, one step on. Span
    ``adamw.update``."""
    with spans.span("adamw.update"):
        state = moments(grads, state, b1=b1, b2=b2, grad_clip=grad_clip)
        apply(params, params.keys(), state, lr, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    return state
