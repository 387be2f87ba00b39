"""Faults planted under the timed path, to show that the correctness
check catches them: ``unchanged`` (the optimizer leaves the state as it
is), ``half_batch`` (the loss and its gradients over the first half of
the rows only, the mean taken over them). Each is a context manager that
patches the program for the run inside it."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, value):
    original = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, original)


def unchanged():
    from repro_torch.optim import adamw
    return _patched(adamw, "update", lambda grads, state, *a, **k: state)


def half_batch():
    from repro_torch.models import api
    loss_fn = api.loss_fn

    def half(model, cfg, batch, *a, **k):
        rows = len(batch["tokens"]) // 2
        return loss_fn(model, cfg, {n: v[:rows] for n, v in batch.items()},
                       *a, **k)

    return _patched(api, "loss_fn", half)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}
