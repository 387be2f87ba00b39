"""Family-dispatching facade: one (init, train, prefill, decode) API.

Counterpart of the reference's ``models/api.py``. The dense, moe, ssm
and vlm families run through :mod:`.transformer`, the hybrid family
through :mod:`.hybrid`, the encdec family through :mod:`.encdec`. The
serving entry points (``init``, ``init_caches``, ``prefill``,
``decode_step``) run without autograd; ``forward_train`` and ``loss_fn``
record a graph for whatever requires a gradient (the train step's
working copy of the parameters; a model's own parameters never do), so
they serve training. ``init`` builds the model on the card unless the
caller passes ``device="cpu"``; without a card and without that argument
it raises. The other entry points run where the model's parameters lie.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.sharding.context import whole_within

from . import encdec, hybrid, transformer
from .layers import resolve_device
from .transformer import ModelConfig


def family_module(cfg: ModelConfig):
    """The module that assembles ``cfg``'s family (its ``init`` takes
    ``(cfg, generator, *, device, dtype)``)."""
    return {"hybrid": hybrid, "encdec": encdec}.get(cfg.family, transformer)


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, *, device=None,
         dtype=torch.float32) -> nn.Module:
    """Random weights from the reference's distributions, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return family_module(cfg).init(cfg, generator, device=device,
                                   dtype=dtype)


def param_axes(model: nn.Module, cfg: ModelConfig
               ) -> Dict[str, Tuple[str, ...]]:
    """{state-dict name: logical axes} of every parameter of ``model``,
    the reference's axes tree (``init``'s second result) without its
    leading ``"layers"`` axis: the port keeps one leaf per layer. Each
    module names its own in ``param_axes``; a parameter without axes
    raises."""
    out: Dict[str, Tuple[str, ...]] = {}
    for prefix, module in model.named_modules():
        for attr, axes in getattr(module, "param_axes", {}).items():
            out[f"{prefix}.{attr}" if prefix else attr] = axes
    missing = [n for n, _ in model.named_parameters() if n not in out]
    if missing:
        raise ValueError(f"{cfg.name}: parameters without logical axes: "
                         f"{missing}")
    return out


def _device(model: nn.Module) -> torch.device:
    return model.embed.w.device


def _tokens(model: nn.Module, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=_device(model)).long()


def _embeds(model: nn.Module, x) -> Optional[torch.Tensor]:
    """Stub frontend embeddings (frames, vision) on the model's device,
    in the dtype they were given."""
    return None if x is None else torch.as_tensor(x, device=_device(model))


def _prefix(model: nn.Module, cfg: ModelConfig, batch: Dict[str, Any]):
    """The vlm family's ``vision_embeds``; no prefix for other families."""
    if cfg.family != "vlm":
        return None
    return _embeds(model, batch.get("vision_embeds"))


def forward_train(model: nn.Module, cfg: ModelConfig,
                  batch: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch → (logits fp32, aux_loss). batch["tokens"] is (B, S); encdec
    adds "frames" (B, S_enc, d), vlm "vision_embeds" (B, P, d), whose
    P positions lead the logits."""
    tokens = _tokens(model, batch["tokens"])
    if cfg.family == "encdec":
        return encdec.apply_train(model, cfg, tokens,
                                  _embeds(model, batch["frames"]))
    if cfg.family == "hybrid":
        return hybrid.apply_train(model, cfg, tokens)
    return transformer.apply_train(model, cfg, tokens,
                                   prefix_embeds=_prefix(model, cfg, batch))


def _vocab_axis(logits):
    """The mesh dim that shards the vocab of DTensor ``logits``, or None
    (plain logits, no vocab shard, or a pending partial sum)."""
    if not isinstance(logits, DTensor) or any(
            p.is_partial() for p in logits.placements):
        return None
    dims = [i for i, p in enumerate(logits.placements)
            if p.is_shard(logits.ndim - 1)]
    return dims[0] if len(dims) == 1 else None


def vocab_parallel(cfg: ModelConfig):
    """DTensor's ``loss_parallel`` where ``shard_logits`` shards the vocab
    (inside ``activation_sharding`` on a mesh whose ``model`` axis of more
    than one device divides it): the cross-entropy's max and sum reduce
    across the vocab shards instead of gathering the whole vocab on every
    rank. It must hold over the loss's forward and backward (the train
    step enters it around both); a null context otherwise."""
    from repro_torch.sharding.context import active_mesh
    mesh = active_mesh()
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if "model" not in names:
        return contextlib.nullcontext()
    size = mesh.size(names.index("model"))
    if size == 1 or cfg.padded_vocab % size:
        return contextlib.nullcontext()
    from torch.distributed.tensor.parallel import loss_parallel
    return loss_parallel()


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Per-row cross-entropy of (N, V) logits and (N,) labels. A DTensor
    whose vocab is sharded runs it on the vocab's own one-dimensional
    mesh (each rank's rows as they are; ``loss_parallel``'s rule takes
    one mesh dim) and hands the rows back in the rows' layout."""
    md = _vocab_axis(logits)
    if md is None:
        return F.cross_entropy(logits, labels, reduction="none")
    mesh = logits.device_mesh
    sub = mesh[mesh.mesh_dim_names[md]]
    rows = [p if i != md else Replicate()
            for i, p in enumerate(logits.placements)]
    lg = DTensor.from_local(logits.to_local(), sub, [Shard(1)],
                            run_check=False)
    lb = DTensor.from_local(labels.redistribute(mesh, rows).to_local(), sub,
                            [Replicate()], run_check=False)
    nll = F.cross_entropy(lg, lb, reduction="none")
    return DTensor.from_local(nll.to_local(), mesh, rows, run_check=False)


def loss_fn(model: nn.Module, cfg: ModelConfig, batch: Dict[str, Any],
            aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (+ ``aux_weight`` × the MoE aux loss) →
    (total, {"loss": cross-entropy, "aux": aux}). ``batch["labels"]``
    (B, S); an optional ``batch["loss_mask"]`` (B, S) weighs the
    positions; the vlm prefix positions carry no labels and are cut."""
    logits, aux = forward_train(model, cfg, batch)
    labels = _tokens(model, batch["labels"])
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    nll = _cross_entropy(
        whole_within(logits, 0, 1).reshape(-1, logits.shape[-1]),
        whole_within(labels, 0, 1).reshape(-1)).view(labels.shape)
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else \
        torch.as_tensor(mask, device=nll.device).to(nll.dtype)
    ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce + aux_weight * aux, {"loss": ce, "aux": aux}


@torch.no_grad()
def init_caches(model: nn.Module, cfg: ModelConfig, batch: int, max_s: int,
                batch_inputs: Optional[Dict[str, Any]] = None,
                dtype=torch.bfloat16):
    """Zeroed caches of ``max_s`` positions for ``batch`` requests; the
    encdec family runs its encoder over ``batch_inputs["frames"]`` here."""
    if cfg.family == "encdec":
        if batch_inputs is None or "frames" not in batch_inputs:
            raise ValueError(f"{cfg.name}: init_caches of the encdec family "
                             f"needs batch_inputs={{'frames': ...}}")
        return encdec.init_caches(model, cfg,
                                  _embeds(model, batch_inputs["frames"]),
                                  max_s, dtype)
    return family_module(cfg).init_caches(cfg, batch, max_s, dtype,
                                          device=_device(model))


@torch.no_grad()
def prefill(model: nn.Module, cfg: ModelConfig, batch: Dict[str, Any],
            caches) -> Tuple[torch.Tensor, Any]:
    """Prompt logits and the caches filled with the prompt. The encdec
    family returns the teacher-forced logits and ``caches`` unchanged, as
    the reference does: its self caches fill token by token in
    ``serve.decode.generate``."""
    tokens = _tokens(model, batch["tokens"])
    if cfg.family == "encdec":
        logits, _ = encdec.apply_train(model, cfg, tokens,
                                       _embeds(model, batch["frames"]))
        return logits, caches
    if cfg.family == "hybrid":
        raise NotImplementedError(
            "hybrid prefill runs through serve.decode chunked path")
    return transformer.apply_prefill(model, cfg, tokens, caches,
                                     prefix_embeds=_prefix(model, cfg, batch))


@torch.no_grad()
def decode_step(model: nn.Module, cfg: ModelConfig, tokens,
                caches) -> Tuple[torch.Tensor, Any]:
    return family_module(cfg).apply_decode(model, cfg,
                                           _tokens(model, tokens), caches)
