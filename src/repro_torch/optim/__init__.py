"""Optimizer stack of the port: AdamW, Muon (Newton–Schulz over the
paper's A·Aᵀ·B expression, association picked per weight shape by the
LAMP discriminant), learning-rate schedules and int8 error-feedback
gradient compression, as in the reference's ``optim``.

Parameters and optimizer state are dicts of tensors keyed by a model's
state-dict names (``blocks.3.mixer.in_proj.w``). The reference stacks a
model's layers on a leading axis, so one of its leaves (``blocks.…``)
holds every layer's slice; the optimizers decide weight decay and Muon's
partition by the reference's leaf (:mod:`.leaves`), so that both packages
update the same numbers the same way. :mod:`.convert` carries the
reference's optimizer state across; it reaches into the models, so it
is imported on its own (``from repro_torch.optim import convert``)."""

from . import adamw, grad_compress, leaves, muon, schedule

__all__ = ["adamw", "grad_compress", "leaves", "muon", "schedule"]
