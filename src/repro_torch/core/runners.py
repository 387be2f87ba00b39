"""The reference package's runner names, over the port's backends.

The port's counterpart of the reference's ``core/runners.py``, the
import surface from before the backend registry:

* :class:`BlasRunner` — alias of
  :class:`~repro_torch.core.backends.BlasBackend` (the ``blas`` entry);
* :func:`reference_execute` — the numpy oracle (the ``numpy`` entry);
* :func:`measure_seconds`, :class:`CacheFlusher` — re-exports.

There is no ``JaxRunner``: its constructor's first argument,
``use_pallas``, chooses between two JAX backends. The port's
counterparts are the registry's device backends,
``get_backend("torch")`` (plain ATen, the reference's ``jax``) and
``get_backend("cuda")`` (the hand-written kernels, its ``pallas``).
New code resolves every executor through the registry::

    from repro_torch.core.backends import get_backend, register_torch_backends
    register_torch_backends()
    runner = get_backend("blas", reps=3)
"""

from __future__ import annotations

from .backends import BlasBackend as BlasRunner
from .backends import CacheFlusher, measure_seconds, reference_execute

__all__ = ["BlasRunner", "CacheFlusher", "measure_seconds",
           "reference_execute"]
