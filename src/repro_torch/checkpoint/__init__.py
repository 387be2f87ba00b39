"""Checkpoints of the port's trainer: the reference's on-disk layout
(:mod:`.store`) and its asynchronous manager with retention and the
preemption hook (:mod:`.manager`)."""

from . import manager, store
from .manager import CheckpointManager

__all__ = ["manager", "store", "CheckpointManager"]
