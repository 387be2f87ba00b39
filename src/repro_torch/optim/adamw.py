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

Weight decay applies to the leaves whose reference leaf has rank 2 or
more (:func:`~repro_torch.optim.leaves.reference_ndim`): every weight
matrix, and also the per-layer vectors of a layer stack, which the
reference stacks into (L, d) arrays.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, NamedTuple

import numpy as np
import torch

from .leaves import reference_ndim

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


def init(params: Mapping[str, torch.Tensor]) -> AdamWState:
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.items()}
    return AdamWState(step=0, mu=zeros,
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
    global norm of ``grad_clip`` (none when it is 0), in place; returns
    the state one step on."""
    names = list(grads)
    gf = [grads[n].float() for n in names]
    if grad_clip > 0:
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
    return state._replace(step=state.step + 1)


@torch.no_grad()
def apply(params: Mapping[str, torch.Tensor], names: Iterable[str],
          state: AdamWState, lr: float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> None:
    """p ← p − lr·(m̂ / (√v̂ + eps) + wd·p) for the leaves ``names``, in
    place, from ``state``'s moments (already at its ``step``)."""
    names = list(names)
    if not names:
        return
    # The bias corrections in float32, as the reference computes them.
    bc1 = float(1 - np.float32(b1) ** np.float32(state.step))
    bc2 = float(1 - np.float32(b2) ** np.float32(state.step))
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
    torch._foreach_add_([params[n] for n in names], mhat, alpha=-lr)


def update(grads: Mapping[str, torch.Tensor], state: AdamWState,
           params: Mapping[str, torch.Tensor], lr: float, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           grad_clip: float = 1.0) -> AdamWState:
    """One AdamW step on every leaf of ``params`` in place (global-norm
    clipping included); returns the new state."""
    state = moments(grads, state, b1=b1, b2=b2, grad_clip=grad_clip)
    apply(params, params.keys(), state, lr, b1=b1, b2=b2, eps=eps,
          weight_decay=weight_decay)
    return state
