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

The step is graph-safe: its counters (``TrainState.step``, the
optimizers' ``step``) are 0-d int32 tensors on the device, advanced in
place; the schedule's lr, AdamW's bias corrections and the clip scale
stay on the device; every master, moment and momentum is written in
place and nothing is read on the host. So :func:`compile_train_step`
captures it in a ``torch.cuda.CUDAGraph``, on a mesh too, as the
reference jit-compiles the step :func:`make_train_step` binds, and a step
is one replay; the same step runs eagerly on the CPU or when asked.
"""

from __future__ import annotations

import functools
import time
from typing import (Any, Callable, Dict, Iterator, List, Mapping,
                    NamedTuple, Tuple)

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import store
from repro_torch.models import api
from repro_torch.models.transformer import ModelConfig
from repro_torch.optim import adamw, muon, schedule as sched
from repro_torch.optim.leaves import reference_ndim
from repro_torch.runtime import spans
from repro_torch.sharding.context import batch_rows


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # fp32 masters: ``model``'s parameters
    opt: Any                          # AdamWState | MuonState
    step: torch.Tensor                # 0-d int32 on the device
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
    step = adamw.counter(model.embed.w.device)
    if mesh is not None:
        from repro_torch.launch import specs
        specs.shard_model(model, cfg, mesh,
                          specs.resolve_policy(cfg, mesh, policy))
        params = dict(model.named_parameters())
        return TrainState(params=params, step=step, model=model,
                          opt=specs.init_optimizer(optimizer, params, cfg,
                                                   mesh))
    params = dict(model.named_parameters())
    opt = muon.init(params) if optimizer == "muon" else adamw.init(params)
    return TrainState(params=params, opt=opt, step=step, model=model)


def checkpoint_tree(state: TrainState) -> Dict[str, Any]:
    """What a checkpoint holds: the reference's TrainState leaves."""
    return {"params": state.params, "opt": state.opt, "step": state.step}


@torch.no_grad()
def load_checkpoint_tree(state: TrainState, tree: Mapping[str, Any]
                         ) -> TrainState:
    """``state`` with a restored :func:`checkpoint_tree` copied into its
    own tensors (masters, moments, momenta and counters), so that a
    captured step goes on reading them; returns ``state``. A step that
    older checkpoints hold as a host int reads back as a 0-d int64 tensor
    and is copied in too; on a mesh the restored counters are replicated
    DTensors, copied whole into the plain ones."""
    restored = dict(store.leaf_paths(tree))
    for name, dst in store.leaf_paths(checkpoint_tree(state)):
        if dst is None:
            continue
        src = restored[name]
        if isinstance(src, DTensor) and not isinstance(dst, DTensor):
            src = src.full_tensor()
        dst.copy_(src)
    return state


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
    working copy's dtypes. Spans ``train.cast`` (the working copy),
    ``train.forward`` (the loss) and ``train.backward`` (its gradients)."""
    names = list(state.params)
    owners = _owners(state.model, names)
    work = []
    with spans.span("train.cast"):
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
                with spans.span("train.forward"):
                    total, metrics = api.loss_fn(state.model, cfg, mb)
                with spans.span("train.backward"):
                    grads = torch.autograd.grad(total, work,
                                                allow_unused=True)
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
    """One step; updates the masters, the optimizer state and the step
    counter in place and returns ``state`` (now one step on) with the
    metrics ``loss`` (the cross-entropy, of the last micro-batch when
    accumulating, as the reference reports it), ``lr``, ``grad_norm``
    (before clipping) and ``aux``, as 0-d float32 tensors on the state's
    device. Span ``train.step``, with ``train.grad_norm`` (the metric's
    norm) beside :func:`_grads`' and the optimizer's."""
    with spans.span("train.step"):
        metrics, grads = _grads(cfg, state, batch, accum_steps,
                                compute_dtype)
        lr = sched.SCHEDULES[schedule](state.step, peak_lr, warmup,
                                       total_steps)
        if optimizer == "muon":
            muon.update(grads, state.opt, state.params, lr,
                        weight_decay=weight_decay)
        else:
            adamw.update(grads, state.opt, state.params, lr,
                         weight_decay=weight_decay)
        with spans.span("train.grad_norm"):
            grad_norm = adamw.global_norm(grads.values())
        out = {"lr": lr, "grad_norm": grad_norm, **metrics}
        out = {k: v.full_tensor() if isinstance(v, DTensor) else v
               for k, v in out.items()}
        state.step.add_(1)
    return state, out


def make_train_step(cfg: ModelConfig, **kw):
    """Bind the static config (``optimizer``, ``peak_lr``, ``warmup``,
    ``total_steps``, ...): returns fn(state, batch), the step that
    :func:`repro_torch.train.loop.train` captures with
    :func:`compile_train_step` (or runs eagerly), as the reference's binds
    the step its ``jax.jit`` compiles."""
    return functools.partial(train_step, cfg=cfg, **kw)


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor of the state a step reads and writes: the masters,
    the optimizer's moments, momenta and counters, and the step."""
    return [t for _, t in store.leaf_paths(checkpoint_tree(state))
            if isinstance(t, torch.Tensor)]


class CompiledTrainStep:
    """A train step captured in a CUDA graph. Each call replays it once,
    one step of :attr:`state` on the batch in :attr:`batch` (static
    buffers: :func:`copy_batch` the next batch into them before a call,
    on a mesh each rank's rows), and returns :attr:`metrics`, the static
    0-d tensors the replay writes (``loss``, ``lr``, ``grad_norm``,
    ``aux``). :attr:`first` holds the
    metrics of the warm-up, a real eager step on the batch the capture
    was given; replays start at the step after it. ``pool_bytes`` is what
    the graph's private memory pool added to the reserved memory,
    ``capture_ms`` the wall time of the warm-up step and the capture,
    ``marks`` the device marks that a recorder active during the capture
    put in the graph (:mod:`repro_torch.runtime.spans`), handed to the
    active recorder after each replay."""

    def __init__(self, graph, state: TrainState,
                 batch: Dict[str, torch.Tensor],
                 metrics: Dict[str, torch.Tensor],
                 first: Dict[str, torch.Tensor], pool_bytes: int,
                 capture_ms: float, marks=()):
        self.graph, self.state, self.batch = graph, state, batch
        self.metrics, self.first = metrics, first
        self.pool_bytes, self.capture_ms = pool_bytes, capture_ms
        self.marks = list(marks)

    def __call__(self) -> Dict[str, torch.Tensor]:
        self.graph.replay()
        spans.replayed(self.marks)
        return self.metrics


def _fingerprint(state: TrainState) -> List[Tuple[int, int]]:
    """(object id, local storage address) of every state tensor: on a
    mesh a replay writes the DTensors' local tensors, so their storage
    must stay too."""
    return [(id(t), (t.to_local() if isinstance(t, DTensor) else t)
             .data_ptr()) for t in state_tensors(state)]


def _same_state(before: List[Tuple[int, int]], new: TrainState) -> None:
    if _fingerprint(new) != before:
        raise RuntimeError("the train step returned new state tensors; a "
                           "replayed graph would read stale state")


def _static(v, device) -> torch.Tensor:
    """A copy of a batch entry that a graph reads: a plain tensor on
    ``device``, or, for a DTensor batch (``shard_batch``'s), a DTensor of
    the same layout over a fresh copy of its local rows, into which
    :func:`copy_batch` copies each rank's rows of the next batch."""
    if isinstance(v, DTensor):
        return DTensor.from_local(v.to_local().clone(), v.device_mesh,
                                  v.placements, run_check=False,
                                  shape=v.shape, stride=v.stride())
    return torch.as_tensor(v).to(device, copy=True)


#: The side stream of every train-step capture on a device, made once, as
#: ``torch.cuda.graph`` keeps one: cuBLAS keeps a workspace (32 MiB on an
#: H100) for each stream it has run on, carved from the cached memory the
#: warm-up step leaves on that stream, so a new stream per capture (a
#: supervisor's restart, another run in the same process) would pin one
#: more cached segment each time.
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _capture_stream(device) -> "torch.cuda.Stream":
    if device.index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device.index]


def copy_batch(static: Mapping[str, torch.Tensor],
               batch: Mapping[str, Any]) -> None:
    """Copy the next global ``batch`` (host or device arrays) into a
    captured step's static buffers (:attr:`CompiledTrainStep.batch`): a
    static DTensor takes this rank's rows
    (:func:`~repro_torch.sharding.context.batch_rows`, the rows
    ``shard_batch`` gives it) into its local tensor."""
    for k, v in batch.items():
        dst, v = static[k], torch.as_tensor(v)
        if isinstance(dst, DTensor):
            dst.to_local().copy_(batch_rows(v, dst.device_mesh))
        else:
            dst.copy_(v)


def compile_train_step(step: Callable, state: TrainState,
                       batch: Mapping[str, torch.Tensor]
                       ) -> CompiledTrainStep:
    """Capture ``step`` (:func:`make_train_step`'s) on ``state`` in a CUDA
    graph. The warm-up runs the first step for real, eagerly, on a side
    stream (one a device, kept for every capture; cuBLAS, the allocator
    and, on a mesh, the process group's communicators set up there) on a
    copy of ``batch`` that becomes the graph's static input; its memory
    is then handed back to the card (``torch.cuda.empty_cache``) and the
    step is captured once on a private pool with
    ``capture_begin(capture_error_mode="global")``. The
    state is not copied (it would cost gigabytes): the warm-up advances
    it, and the first replay takes the next step. A step that returns new
    state tensors instead of writing them in place raises
    ``RuntimeError``, and so does any capture error. A random draw in the
    step (none today) would come from the default CUDA generator, which
    the capture registers with the graph itself. A state on the CPU
    raises ``ValueError``.

    A sharded state (DTensor masters and moments, :func:`make_train_state`
    with ``mesh=``) is captured as it is, under the caller's
    ``activation_sharding``: DTensor's dispatch runs on the host while
    the graph records, and a replay runs the local kernels and the
    collectives it issued, writing the local tensors in place. The static
    batch keeps the given batch's layout. The warm-up's collectives are
    drained before the capture (a synchronise and, on NCCL, a barrier),
    and a sharded step must draw no random number (``RuntimeError``):
    DTensor's RNG tracker sets the generator's state on the host, which a
    replay would not repeat.

    Host spans ``train.capture.warmup`` and ``train.capture.record``;
    counters ``train.capture.count`` and ``train.capture.pool_bytes``."""
    device = state.step.device
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, the state "
                         f"lies on {device}")
    t0 = time.perf_counter()
    before = _fingerprint(state)
    sharded = any(isinstance(p, DTensor) for p in state.params.values())
    static = {k: _static(v, device) for k, v in batch.items()}
    generator = torch.cuda.default_generators[device.index]
    offset = generator.get_offset()
    stream = _capture_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.device(device), torch.cuda.stream(stream):
        with spans.span("train.capture.warmup", device=False):
            new, first = step(state, static)
            _same_state(before, new)
            del new
            if sharded and generator.get_offset() != offset:
                raise RuntimeError(
                    "the sharded train step drew random numbers: DTensor's "
                    "RNG tracker sets the generator's state on the host, "
                    "which a replay would not repeat")
            torch.cuda.synchronize(device)
            if sharded and dist.is_initialized() and \
                    dist.get_backend() == "nccl":
                # no work of the group may be pending while the graph
                # records: the NCCL watchdog thread queries pending works'
                # events, a call a "global" capture may refuse in another
                # thread
                dist.barrier(device_ids=[device.index])
                torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        with spans.span("train.capture.record", device=False), \
                spans.capturing() as marks:
            graph = torch.cuda.CUDAGraph()
            reserved = torch.cuda.memory_reserved(device)
            graph.capture_begin(capture_error_mode="global")
            try:
                new, metrics = step(state, static)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is already invalid; report the cause
                raise
            graph.capture_end()
            _same_state(before, new)
            pool = max(0, torch.cuda.memory_reserved(device) - reserved)
    torch.cuda.current_stream(device).wait_stream(stream)
    torch.cuda.synchronize(device)
    spans.count("train.capture.count")
    spans.count("train.capture.pool_bytes", pool)
    return CompiledTrainStep(graph, state, static, metrics, first, pool,
                             (time.perf_counter() - t0) * 1e3, marks)
