"""The port's trainer: the train step (gradient accumulation, the
mixed-precision working copy, remat), its capture in a CUDA graph, and
the checkpointed training loop."""

from . import loop, train_step

__all__ = ["loop", "train_step"]
