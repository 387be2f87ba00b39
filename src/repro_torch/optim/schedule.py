"""LR schedules (warmup + cosine / linear / constant) as pure functions of
the step, in float32 as the reference computes them: each returns a 0-d
float32 tensor. The train step passes its step counter, a 0-d integer
tensor on the device, and gets the lr on that device without a host read
or a tensor built from host data, as a captured step needs; a Python int
step gives the lr on the CPU."""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.as_tensor(step, dtype=torch.float32)
    return torch.as_tensor(step, dtype=torch.float32)


def warmup_cosine(step, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    s = _step(step)
    warm = peak_lr * s / max(1, warmup)
    t = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)


def warmup_linear(step, peak_lr: float, warmup: int,
                  total: int) -> torch.Tensor:
    s = _step(step)
    warm = peak_lr * s / max(1, warmup)
    t = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    return torch.where(s < warmup, warm, peak_lr * (1 - t))


def constant(step, peak_lr: float, warmup: int = 0,
             total: int = 0) -> torch.Tensor:
    s = _step(step)
    if warmup:
        return torch.clamp(peak_lr * s / warmup, max=peak_lr)
    return torch.full_like(s, peak_lr)


SCHEDULES = {
    "cosine": warmup_cosine,
    "linear": warmup_linear,
    "constant": constant,
}
