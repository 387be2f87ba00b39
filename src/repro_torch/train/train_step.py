"""The train step: loss → gradients (optional micro-batch accumulation)
→ optimizer update, as the reference's ``train/train_step.py``.

:class:`TrainState` holds the fp32 master parameters (the model's own
parameters, ``requires_grad=False``), the optimizer state and the step.
Each step differentiates a working copy in ``compute_dtype`` (bf16 by
default) of every fp32 leaf whose reference leaf has rank 2 or more
(:func:`~repro_torch.optim.leaves.reference_ndim`), as the reference's
``_grads`` does; the other leaves are differentiated as they are. The
working copy is installed in the model as its parameters for the step's
forward and backward passes (so a block that ``remat`` recomputes in the
backward pass reads it too) and the masters are put back afterwards; the
optimizer then updates the masters in place.

On a mesh (:func:`make_train_state` with ``mesh=``) the masters, the
working copy, the gradients and the moments are DTensors: the same code
runs, DTensor inserting the collectives (gradient reductions onto the
moments' FSDP layout, gathers onto the parameters'), and the returned
metrics are plain replicated tensors.

The step runs eagerly: the reference jit-compiles it, and a graph-captured
step waits for the capture design of the decode step (ROADMAP A6).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, NamedTuple, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.models import api
from repro_torch.models.transformer import ModelConfig
from repro_torch.optim import adamw, muon, schedule as sched
from repro_torch.optim.leaves import reference_ndim


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # fp32 masters: ``model``'s parameters
    opt: Any                          # AdamWState | MuonState
    step: int
    model: nn.Module


def make_train_state(cfg: ModelConfig, optimizer: str = "adamw",
                     seed: int = 0, device=None, mesh=None,
                     policy: str = "auto") -> TrainState:
    """Random fp32 weights from ``seed`` (``api.init``) on ``device`` (the
    card unless ``device="cpu"``) and a fresh optimizer state. On a
    ``mesh`` every rank draws the same weights and keeps its shard: the
    parameters become DTensors laid out by the rules of ``policy``
    (fsdp | zero1 | auto) and the moments by the FSDP rules
    (:mod:`repro_torch.launch.specs`)."""
    model = api.init(cfg, seed=seed, device=device, dtype=torch.float32)
    if mesh is not None:
        from repro_torch.launch import specs
        specs.shard_model(model, cfg, mesh,
                          specs.resolve_policy(cfg, mesh, policy))
        params = dict(model.named_parameters())
        return TrainState(params=params, step=0, model=model,
                          opt=specs.init_optimizer(optimizer, params, cfg,
                                                   mesh))
    params = dict(model.named_parameters())
    opt = muon.init(params) if optimizer == "muon" else adamw.init(params)
    return TrainState(params=params, opt=opt, step=0, model=model)


def checkpoint_tree(state: TrainState) -> Dict[str, Any]:
    """What a checkpoint holds: the reference's TrainState leaves."""
    return {"params": state.params, "opt": state.opt, "step": state.step}


@torch.no_grad()
def load_checkpoint_tree(state: TrainState, tree: Mapping[str, Any]
                         ) -> TrainState:
    """``state`` with a restored :func:`checkpoint_tree`: the masters
    overwritten in place, the optimizer state and step replaced."""
    for name, p in state.params.items():
        p.copy_(tree["params"][name])
    return state._replace(opt=tree["opt"], step=int(tree["step"]))


def _owners(model: nn.Module, names) -> List[Tuple[nn.Module, str]]:
    out = []
    for name in names:
        prefix, _, attr = name.rpartition(".")
        out.append((model.get_submodule(prefix), attr))
    return out


def _install(owners, tensors) -> None:
    for (module, attr), t in zip(owners, tensors):
        setattr(module, attr, t)


def _micro_batches(batch: Mapping[str, Any], n: int) -> Iterator[Dict]:
    if n == 1:
        yield dict(batch)
        return
    size = len(batch["tokens"]) // n
    for i in range(n):
        yield {k: v[i * size:(i + 1) * size] for k, v in batch.items()}


def _grads(cfg: ModelConfig, state: TrainState, batch: Mapping[str, Any],
           accum_steps: int, compute_dtype):
    """(metrics of the last micro-batch, gradients by name): fp32 sums
    over ``accum_steps`` micro-batches, or one batch's gradients in the
    working copy's dtypes."""
    names = list(state.params)
    owners = _owners(state.model, names)
    work = []
    for name in names:
        p = state.params[name]
        w = p.to(compute_dtype) if p.dtype == torch.float32 \
            and reference_ndim(name, p) >= 2 else p
        work.append(nn.Parameter(w.detach(), requires_grad=True))
    acc = None
    _install(owners, work)
    try:
        for mb in _micro_batches(batch, max(1, accum_steps)):
            with api.vocab_parallel(cfg):
                total, metrics = api.loss_fn(state.model, cfg, mb)
                grads = torch.autograd.grad(total, work, allow_unused=True)
            grads = [torch.zeros_like(w) if g is None else g
                     for w, g in zip(work, grads)]
            if accum_steps <= 1:
                acc = grads
            elif acc is None:
                acc = [g.float() / accum_steps for g in grads]
            else:
                torch._foreach_add_(acc, [g.float() / accum_steps
                                          for g in grads])
    finally:
        _install(owners, [state.params[n] for n in names])
    return ({k: v.detach().float() for k, v in metrics.items()},
            dict(zip(names, acc)))


def train_step(state: TrainState, batch: Mapping[str, Any], *,
               cfg: ModelConfig, optimizer: str = "adamw",
               peak_lr: float = 3e-4, warmup: int = 100,
               total_steps: int = 10000, schedule: str = "cosine",
               accum_steps: int = 1, compute_dtype=torch.bfloat16,
               weight_decay: float = 0.1
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step; updates the masters and the optimizer state in place and
    returns the state one step on with the metrics ``loss`` (the
    cross-entropy, of the last micro-batch when accumulating, as the
    reference reports it), ``lr``, ``grad_norm`` (before clipping) and
    ``aux``, as 0-d float32 tensors on the state's device."""
    metrics, grads = _grads(cfg, state, batch, accum_steps, compute_dtype)
    lr_t = sched.SCHEDULES[schedule](state.step, peak_lr, warmup,
                                     total_steps)
    lr = float(lr_t)
    if optimizer == "muon":
        opt = muon.update(grads, state.opt, state.params, lr,
                          weight_decay=weight_decay)
    else:
        opt = adamw.update(grads, state.opt, state.params, lr,
                           weight_decay=weight_decay)
    out = {"lr": lr_t.to(metrics["loss"].device),
           "grad_norm": adamw.global_norm(grads.values()), **metrics}
    out = {k: v.full_tensor() if isinstance(v, DTensor) else v
           for k, v in out.items()}
    return state._replace(opt=opt, step=state.step + 1), out
