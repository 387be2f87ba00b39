"""Abstract states and shardings for every (arch × shape) cell.

Counterpart of the reference's ``launch/specs.py``. The reference builds
``ShapeDtypeStruct`` stand-ins with ``NamedSharding``s; here a state is
built from DTensors whose local shards are what the mode makes them:
under ``FakeTensorMode`` (the dry-run) no byte is allocated, outside it
the same functions give real sharded state at small sizes. Layouts:

  * params/optimizer — logical-axis rules (TP on ``model``, FSDP on
    ``data`` (+ ``pod``)); the moments always take the FSDP rules;
  * batch — the batch dim over (pod, data);
  * KV caches — batch over (pod, data), **sequence over model** (the
    decode softmax then runs over sequence shards,
    :func:`repro_torch.models.attention.apply_decode`);
  * SSM caches — batch over (pod, data), heads (state) or channels
    (conv tail) over model.

A spec is the tuple of :mod:`repro_torch.sharding.rules`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor
import torch.distributed.tensor as dtensor

from repro_torch.configs import ShapeSpec
from repro_torch.models import api
from repro_torch.models.attention import KVCache
from repro_torch.models.encdec import EncDecCaches
from repro_torch.models.hybrid import HybridCaches
from repro_torch.models.ssm import SSMCache
from repro_torch.models.transformer import LayerCaches, ModelConfig
from repro_torch.optim import adamw, muon
from repro_torch.serve.decode import ServeState
from repro_torch.sharding import rules as shrules
from repro_torch.sharding.context import default_batch_axes
from repro_torch.train.train_step import TrainState

Spec = shrules.Spec


def _div(n: int, mesh, axis) -> bool:
    if axis is None:
        return False
    sizes = shrules.axis_sizes(mesh)
    names = axis if isinstance(axis, tuple) else (axis,)
    return n % math.prod(sizes[a] for a in names) == 0


# ------------------------------------------------------------- params ---

def abstract_init(cfg: ModelConfig, dtype=torch.float32
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple]]:
    """({name: meta tensor}, {name: logical axes}), allocation-free."""
    model = api.family_module(cfg).init(cfg, None, device="meta",
                                        dtype=dtype)
    return dict(model.named_parameters()), api.param_axes(model, cfg)


def param_shardings(cfg: ModelConfig, mesh, dtype=torch.float32,
                    policy: str = "fsdp"):
    """(meta shapes, {name: spec}, {name: placements})."""
    shapes, axes = abstract_init(cfg, dtype)
    specs = shrules.params_specs(axes, shapes, mesh,
                                 rules=shrules.rules_for(policy))
    return shapes, specs, shrules.shardings_of(specs, mesh)


def resolve_policy(cfg: ModelConfig, mesh, policy: str) -> str:
    if policy == "auto":
        return shrules.pick_param_policy(cfg.param_count(), mesh)
    return policy


def _install(model: nn.Module, name: str, value: torch.Tensor) -> None:
    prefix, _, attr = name.rpartition(".")
    owner = model.get_submodule(prefix) if prefix else model
    setattr(owner, attr, nn.Parameter(value, requires_grad=False))


@torch.no_grad()
def shard_model(model: nn.Module, cfg: ModelConfig, mesh,
                policy: str = "fsdp") -> Dict[str, Spec]:
    """Replace every parameter of ``model`` by a DTensor laid out by the
    rules of ``policy`` (each rank keeps its own shard of the same
    weights: no communication); returns the specs."""
    specs = shrules.params_specs(api.param_axes(model, cfg),
                                 dict(model.named_parameters()), mesh,
                                 rules=shrules.rules_for(policy))
    for name, p in list(model.named_parameters()):
        _install(model, name, distribute_tensor(
            p.detach(), mesh, shrules.placements_for(specs[name], mesh),
            src_data_rank=None))
    return specs


def abstract_model(cfg: ModelConfig, mesh, dtype=torch.float32,
                   policy: str = "fsdp") -> Tuple[nn.Module, Dict]:
    """``cfg``'s model with DTensor parameters of local shards made by the
    active mode (no allocation under ``FakeTensorMode``), and its specs."""
    shapes, specs, placements = param_shardings(cfg, mesh, dtype, policy)
    model = api.family_module(cfg).init(cfg, None, device="meta",
                                        dtype=dtype)
    for name, shape in shapes.items():
        _install(model, name, dtensor.empty(
            tuple(shape.shape), dtype=dtype, device_mesh=mesh,
            placements=placements[name]))
    return model, specs


def moments_like(params: Dict[str, torch.Tensor], cfg: ModelConfig, mesh,
                 axes: Optional[Dict[str, Tuple]] = None
                 ) -> Dict[str, torch.Tensor]:
    """float32 zeros per parameter, laid out by the FSDP rules (the
    reference's moments are always ZeRO-sharded over the data axes)."""
    if axes is None:
        _, axes = abstract_init(cfg)
    specs = shrules.params_specs(axes, params, mesh)
    return {n: dtensor.zeros(tuple(p.shape), dtype=torch.float32,
                             device_mesh=mesh,
                             placements=shrules.placements_for(specs[n],
                                                               mesh))
            for n, p in params.items()}


def init_optimizer(optimizer: str, params: Dict[str, torch.Tensor],
                   cfg: ModelConfig, mesh):
    """The optimizer state of ``params``, its moments (and Muon's
    momenta) laid out by the FSDP rules, its step counters plain 0-d
    tensors on the mesh's device type."""
    _, axes = abstract_init(cfg)
    aw = adamw.AdamWState(step=adamw.counter(mesh.device_type),
                          mu=moments_like(params, cfg, mesh, axes),
                          nu=moments_like(params, cfg, mesh, axes))
    if optimizer != "muon":
        return aw
    labels = muon.partition(params)
    mom = moments_like({n: p for n, p in params.items() if labels[n]},
                       cfg, mesh, axes)
    return muon.MuonState(step=adamw.counter(mesh.device_type),
                          momentum={n: mom.get(n) for n in params},
                          adamw=aw)


def abstract_train_state(cfg: ModelConfig, mesh, dtype=torch.float32,
                         policy: str = "auto", optimizer: str = "adamw"):
    """(TrainState, {"params": placements, "moments": placements}).

    ``policy``: fsdp | zero1 | auto — parameter sharding across the data
    axes; the moments are always data-sharded; ``auto`` picks by modeled
    per-device memory (:func:`~repro_torch.sharding.rules.
    pick_param_policy`)."""
    policy = resolve_policy(cfg, mesh, policy)
    model, _ = abstract_model(cfg, mesh, dtype, policy)
    params = dict(model.named_parameters())
    opt = init_optimizer(optimizer, params, cfg, mesh)
    _, _, pshard = param_shardings(cfg, mesh, dtype, policy)
    _, _, mshard = param_shardings(cfg, mesh, dtype, "fsdp")
    state = TrainState(params=params, opt=opt, model=model,
                       step=adamw.counter(mesh.device_type))
    return state, {"params": pshard, "moments": mshard, "policy": policy}


def abstract_batch(cfg: ModelConfig, shape: ShapeSpec, mesh
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple]]:
    """(batch of DTensors, {key: placements}), the batch dim over the data
    axes; the vlm prefix takes the first ``vision_tokens`` positions of
    the sequence budget."""
    b, s = shape.global_batch, shape.seq_len
    bspec = shrules.batch_spec(mesh)
    pl = shrules.placements_for(bspec, mesh) if _div(
        b, mesh, bspec[0]) else shrules.replicated(mesh)
    s_tok = s - cfg.vision_tokens if cfg.family == "vlm" else s
    specs: Dict[str, Any] = {
        "tokens": ((b, s_tok), torch.long),
        "labels": ((b, s_tok), torch.long),
    }
    if cfg.family == "encdec":
        specs["frames"] = ((b, cfg.encoder_seq, cfg.d_model),
                           torch.bfloat16)
    if cfg.family == "vlm":
        specs["vision_embeds"] = ((b, cfg.vision_tokens, cfg.d_model),
                                  torch.bfloat16)
    batch = {k: dtensor.zeros(shp, dtype=dt, device_mesh=mesh,
                              placements=pl)
             for k, (shp, dt) in specs.items()}
    return batch, {k: pl for k in specs}


# ------------------------------------------------------------- caches ----

def cache_specs(cfg: ModelConfig, caches: Any, mesh) -> Any:
    """Specs of a (stacked) cache tree by structure, the reference's."""
    bax = default_batch_axes(mesh)

    def kv_spec(arr, dim_s=2):
        # (L, B, S, H, D)
        entries = [None] * arr.ndim
        entries[1] = bax if _div(arr.shape[1], mesh, bax) else None
        if _div(arr.shape[dim_s], mesh, "model"):
            entries[dim_s] = "model"
        return tuple(entries)

    def lead_spec(arr, dim):
        # (L, B, H, N, P) state: heads; (L, B, K, C) conv: channels
        entries = [None] * arr.ndim
        entries[1] = bax if _div(arr.shape[1], mesh, bax) else None
        if _div(arr.shape[dim], mesh, "model"):
            entries[dim] = "model"
        return tuple(entries)

    def walk(obj):
        if isinstance(obj, KVCache):
            return obj._replace(k=kv_spec(obj.k), v=kv_spec(obj.v),
                                length=())
        if isinstance(obj, SSMCache):
            return obj._replace(conv=lead_spec(obj.conv, 3),
                                state=lead_spec(obj.state, 2), length=())
        if isinstance(obj, LayerCaches):
            return LayerCaches(
                kv=walk(obj.kv) if obj.kv is not None else None,
                ssm=walk(obj.ssm) if obj.ssm is not None else None)
        if isinstance(obj, EncDecCaches):
            return EncDecCaches(self_kv=walk(obj.self_kv),
                                cross_k=kv_spec(obj.cross_k),
                                cross_v=kv_spec(obj.cross_v))
        if isinstance(obj, HybridCaches):
            return HybridCaches(ssm=walk(obj.ssm),
                                shared_kv=walk(obj.shared_kv))
        raise TypeError(type(obj))

    return walk(caches)


def _map_arrays(caches: Any, specs: Any, fn) -> Any:
    """``caches`` with every array leaf replaced by fn(leaf, spec)."""
    if isinstance(caches, torch.Tensor):
        return fn(caches, specs)
    if isinstance(caches, tuple) and hasattr(caches, "_fields"):
        return caches._replace(**{
            f: _map_arrays(getattr(caches, f), getattr(specs, f), fn)
            for f in caches._fields
            if isinstance(getattr(caches, f), (torch.Tensor, tuple))})
    return caches


def shard_caches(cfg: ModelConfig, caches: Any, mesh) -> Any:
    """``caches`` (plain tensors, the same on every rank) as DTensors laid
    out by :func:`cache_specs`. The lengths (0-d, replicated in the
    specs) stay plain tensors, the same on every rank: decode reads them
    beside the DTensors, and writes each rank's shard at them, on the
    device."""
    specs = cache_specs(cfg, caches, mesh)
    return _map_arrays(caches, specs, lambda t, s: t if isinstance(
        t, DTensor) or t.dim() == 0 else distribute_tensor(
            t, mesh, shrules.placements_for(s, mesh), src_data_rank=None))


def abstract_serve_state(cfg: ModelConfig, shape: ShapeSpec, mesh,
                         dtype=torch.bfloat16, model: nn.Module = None):
    """(ServeState, cache specs, model): the cache of ``shape``'s batch and
    length for a bfloat16 model with sharded parameters (the encdec
    family runs its encoder over zero frames to fill its cross K/V)."""
    if model is None:
        model, _ = abstract_model(cfg, mesh, dtype)
    b, max_s = shape.global_batch, shape.seq_len
    bi = None
    if cfg.family == "encdec":
        bi = {"frames": torch.zeros((b, cfg.encoder_seq, cfg.d_model),
                                    dtype=dtype)}
    caches = shard_caches(cfg, api.init_caches(model, cfg, b, max_s,
                                               batch_inputs=bi,
                                               dtype=dtype), mesh)
    bspec = shrules.batch_spec(mesh)
    pl = shrules.placements_for(bspec, mesh) if _div(
        b, mesh, bspec[0]) else shrules.replicated(mesh)
    last = dtensor.zeros((b, 1), dtype=torch.long, device_mesh=mesh,
                         placements=pl)
    state = ServeState(caches=caches, last_tokens=last, rng=None)
    return state, cache_specs(cfg, caches, mesh), model
