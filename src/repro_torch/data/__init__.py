"""Token sources and prefetch of the port's trainer: the reference's
``data/pipeline.py``, copied."""

from .pipeline import MemmapLM, Prefetcher, SyntheticLM

__all__ = ["MemmapLM", "Prefetcher", "SyntheticLM"]
