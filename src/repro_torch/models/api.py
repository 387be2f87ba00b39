"""Family-dispatching facade: one (init, train, prefill, decode) API.

Counterpart of the reference's ``models/api.py``. The dense, moe and ssm
families run through :mod:`.transformer`, the hybrid family through
:mod:`.hybrid`; encdec and vlm raise :class:`NotImplementedError` naming
ROADMAP A7. Every entry point runs without autograd. ``init`` builds the
model on the card unless the caller passes ``device="cpu"``; without a
card and without that argument it raises. The other entry points run
where the model's parameters lie.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from . import hybrid, transformer
from .layers import resolve_device
from .transformer import ModelConfig


def family_module(cfg: ModelConfig):
    """The module that assembles ``cfg``'s family (its ``init`` takes
    ``(cfg, generator, *, device, dtype)``)."""
    return hybrid if cfg.family == "hybrid" else transformer


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, *, device=None,
         dtype=torch.float32) -> nn.Module:
    """Random weights from the reference's distributions, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return family_module(cfg).init(cfg, generator, device=device,
                                   dtype=dtype)


def _device(model: nn.Module) -> torch.device:
    return model.embed.w.device


def _tokens(model: nn.Module, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=_device(model)).long()


@torch.no_grad()
def forward_train(model: nn.Module, cfg: ModelConfig,
                  batch: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch → (logits fp32, aux_loss); batch["tokens"] is (B, S)."""
    tokens = _tokens(model, batch["tokens"])
    return family_module(cfg).apply_train(model, cfg, tokens)


def init_caches(model: nn.Module, cfg: ModelConfig, batch: int, max_s: int,
                dtype=torch.bfloat16):
    return family_module(cfg).init_caches(cfg, batch, max_s, dtype,
                                          device=_device(model))


@torch.no_grad()
def prefill(model: nn.Module, cfg: ModelConfig, batch: Dict[str, Any],
            caches) -> Tuple[torch.Tensor, Any]:
    if cfg.family == "hybrid":
        raise NotImplementedError(
            "hybrid prefill runs through serve.decode chunked path")
    return transformer.apply_prefill(model, cfg,
                                     _tokens(model, batch["tokens"]), caches)


@torch.no_grad()
def decode_step(model: nn.Module, cfg: ModelConfig, tokens,
                caches) -> Tuple[torch.Tensor, Any]:
    return family_module(cfg).apply_decode(model, cfg,
                                           _tokens(model, tokens), caches)
