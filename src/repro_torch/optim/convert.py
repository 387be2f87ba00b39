"""Carry the reference package's optimizer state into the port.

``from_reference_optimizer(opt, cfg)`` takes the reference's
``AdamWState`` or ``MuonState`` — trees of the parameters' structure,
each stack of layers on axis 0 — and returns the port's optimizer state
keyed by the model's state-dict names, leaf by leaf as
:func:`repro_torch.models.convert.from_reference_params` carries the
weights, so that both packages can train on from one state. This module
imports no JAX; callers hand it arrays.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import api, convert
from repro_torch.models.layers import resolve_device
from repro_torch.models.transformer import ModelConfig

from . import adamw, muon


def from_reference_optimizer(opt: Any, cfg: ModelConfig, *, device=None):
    """The reference's ``AdamWState`` (``step``, ``mu``, ``nu``) or
    ``MuonState`` (``step``, ``momentum``, ``adamw``) as the port's
    :class:`~repro_torch.optim.adamw.AdamWState` /
    :class:`~repro_torch.optim.muon.MuonState` on ``device`` (the card
    unless ``device="cpu"``), fp32 leaves keyed by the port's parameter
    names, the step a 0-d int32 counter on ``device``. The momentum's
    ``None`` leaves (AdamW's in Muon) must be exactly the port's
    non-matrix leaves."""
    device = resolve_device(device)
    expected = api.family_module(cfg).init(cfg, None,
                                           device="meta").state_dict()

    def tree(t, what):
        flat = convert._reference_state(t, cfg)
        convert._check_leaves(cfg, flat, expected, what)
        return {n: None if flat[n] is None else torch.from_numpy(
            np.array(flat[n], dtype=np.float32)).to(device)
            for n in expected}

    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                        device=device)
    if hasattr(opt, "momentum"):
        momentum = tree(opt.momentum, "Muon momenta")
        labels = muon.partition(expected)
        wrong = sorted(n for n, m in momentum.items()
                       if (m is not None) != labels[n])
        if wrong:
            raise ValueError(f"{cfg.name}: the reference's Muon matrices "
                             f"differ from the port's at {wrong}")
        return muon.MuonState(step=step, momentum=momentum,
                              adamw=from_reference_optimizer(
                                  opt.adamw, cfg, device=device))
    return adamw.AdamWState(step=step, mu=tree(opt.mu, "AdamW moments"),
                            nu=tree(opt.nu, "AdamW moments"))
