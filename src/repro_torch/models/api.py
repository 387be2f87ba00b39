"""Family-dispatching facade: one (init, train, prefill, decode) API.

Counterpart of the reference's ``models/api.py``. Only the dense family
is ported; the others raise :class:`NotImplementedError` naming ROADMAP
A7. Every entry point runs without autograd. ``init`` builds the model on
the card unless the caller passes ``device="cpu"``; without a card and
without that argument it raises. The other entry points run where the
model's parameters lie.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from . import transformer
from .layers import resolve_device
from .transformer import DecoderLM, LayerCaches, ModelConfig


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, *, device=None,
         dtype=torch.float32) -> DecoderLM:
    """Random weights from the reference's distributions, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return transformer.init(cfg, generator, device=device, dtype=dtype)


def _device(model: DecoderLM) -> torch.device:
    return model.embed.w.device


def _tokens(model: DecoderLM, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=_device(model)).long()


@torch.no_grad()
def forward_train(model: DecoderLM, cfg: ModelConfig,
                  batch: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch → (logits fp32, aux_loss); batch["tokens"] is (B, S)."""
    return transformer.apply_train(model, cfg, _tokens(model, batch["tokens"]))


def init_caches(model: DecoderLM, cfg: ModelConfig, batch: int, max_s: int,
                dtype=torch.bfloat16) -> LayerCaches:
    return transformer.init_caches(cfg, batch, max_s, dtype,
                                   device=_device(model))


@torch.no_grad()
def prefill(model: DecoderLM, cfg: ModelConfig, batch: Dict[str, Any],
            caches: LayerCaches) -> Tuple[torch.Tensor, LayerCaches]:
    return transformer.apply_prefill(model, cfg,
                                     _tokens(model, batch["tokens"]), caches)


@torch.no_grad()
def decode_step(model: DecoderLM, cfg: ModelConfig, tokens,
                caches: LayerCaches) -> Tuple[torch.Tensor, LayerCaches]:
    return transformer.apply_decode(model, cfg, _tokens(model, tokens),
                                    caches)
