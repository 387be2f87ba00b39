"""Carry the reference package's weights into the port.

``from_reference_params(params, cfg)`` takes the reference's parameter
pytree — nested dicts of arrays (numpy or anything ``numpy.asarray``
reads, bfloat16 included), each stack of layers on axis 0 — and returns
the port's model of ``cfg``'s family holding the same values: the
attention blocks' ``attn``/``mlp``/``moe`` leaves, the SSM blocks'
``mixer`` leaves, the hybrid family's unstacked ``shared`` block beside
its stacked ``blocks``, and the encdec family's ``encoder`` stack (of
``encoder_layers``) and ``decoder`` stack (of ``n_layers``) beside its
``embed``, ``enc_norm`` and ``final_norm``. Every leaf must land on
exactly one parameter of the same shape: a missing, unused or
mis-shaped leaf raises :class:`ValueError`. The optimizer state's
trees go through :mod:`repro_torch.optim.convert`. This module imports
no JAX; callers hand it arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .api import family_module
from .layers import resolve_device
from .transformer import ModelConfig


def _flatten(tree: Mapping[str, Any], prefix: str,
             out: Dict[str, Optional[np.ndarray]]) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _flatten(value, f"{prefix}{key}.", out)
        else:
            out[f"{prefix}{key}"] = None if value is None \
                else np.asarray(value)


def _check_leaves(cfg: ModelConfig, flat: Mapping[str, Any],
                  expected: Mapping[str, torch.Tensor], what: str) -> None:
    """Every leaf of ``flat`` lands on exactly one of ``expected`` with its
    shape (a ``None`` leaf, Muon's non-matrix momentum, has none)."""
    missing = sorted(set(expected) - set(flat))
    unused = sorted(set(flat) - set(expected))
    if missing or unused:
        raise ValueError(f"{cfg.name}: reference {what} do not match "
                         f"the port's: missing {missing}, unused {unused}")
    for name, want in expected.items():
        got = flat[name]
        if got is not None and tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"{name}: reference shape "
                             f"{tuple(got.shape)}, port shape "
                             f"{tuple(want.shape)}")


def _reference_state(params: Mapping[str, Any],
                    cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The reference pytree as state-dict keys: ``<stack>.<i>.<path>`` for
    each layer ``i`` of a stacked leaf (``blocks``, ``encoder``,
    ``decoder``), ``<path>`` otherwise."""
    depths = {"blocks": cfg.n_layers, "decoder": cfg.n_layers,
              "encoder": cfg.encoder_layers}
    flat: Dict[str, np.ndarray] = {}
    for key, value in params.items():
        if key not in depths:
            _flatten({key: value}, "", flat)
            continue
        depth = depths[key]
        stacked: Dict[str, np.ndarray] = {}
        _flatten(value, "", stacked)
        for path, arr in stacked.items():
            if arr is None:         # Muon's momentum of a non-matrix leaf
                flat.update({f"{key}.{i}.{path}": None for i in range(depth)})
                continue
            if arr.ndim == 0 or arr.shape[0] != depth:
                raise ValueError(f"{key}.{path}: leading axis of shape "
                                 f"{arr.shape} is not the {depth} layers")
            for i in range(depth):
                flat[f"{key}.{i}.{path}"] = arr[i]
    return flat


@torch.no_grad()
def from_reference_params(params: Mapping[str, Any], cfg: ModelConfig, *,
                          device=None, dtype=torch.float32) -> nn.Module:
    """The reference's weights in a port model on ``device`` (the card
    unless ``device="cpu"``), cast to ``dtype``."""
    device = resolve_device(device)
    model = family_module(cfg).init(cfg, None, device="meta", dtype=dtype)
    flat = _reference_state(params, cfg)
    _check_leaves(cfg, flat, model.state_dict(), "parameters")
    model = model.to_empty(device=device)
    for name, param in model.state_dict().items():
        value = np.array(flat[name], dtype=np.float32)   # a writable copy
        param.copy_(torch.from_numpy(value).to(dtype))
    return model

