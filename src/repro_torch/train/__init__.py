"""The port's trainer: the eager train step (gradient accumulation, the
mixed-precision working copy, remat) and the checkpointed training loop."""

from . import loop, train_step

__all__ = ["loop", "train_step"]
