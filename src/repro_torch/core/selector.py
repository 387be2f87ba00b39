"""Selection façade over the discriminant registry.

The port's counterpart of the reference package's ``core/selector.py``.
The policies themselves live in :mod:`repro_torch.core.discriminants` — a
registry (``register_discriminant`` / ``get_discriminant`` /
``registered_discriminants``) shipping ``flops``, ``perfmodel``,
``hybrid``, ``roofline``, ``measured`` and ``rankk``, each declaring the
capability flags (``requires_profile`` / ``requires_measurement``) this
shim validates arguments against. ``select`` returns a ranked list so
callers can implement fallbacks; the planner takes rank 0.

The pre-registry module-level ``DISCRIMINANTS`` tuple is deprecated:
import :func:`~repro_torch.core.discriminants.registered_discriminants`
instead (the alias still resolves, with a ``DeprecationWarning``).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

from .algorithms import Algorithm
from .discriminants import (
    DiscriminantContext,
    as_hybrid,
    get_discriminant,
    registered_discriminants,
    validate_arguments,
)
from .perfmodel import KernelProfile

__all__ = [
    "as_hybrid", "rank_by_flops", "rank_by_perfmodel", "rank_by_hybrid",
    "rank_by_measurement", "registered_discriminants", "select",
    "select_expression",
]


def rank_by_flops(algos: Sequence[Algorithm]) -> List[Algorithm]:
    """Ascending FLOP count, ties broken by name (deterministic)."""
    return get_discriminant("flops").rank(algos, DiscriminantContext())


def rank_by_perfmodel(
    algos: Sequence[Algorithm],
    profile: Optional[KernelProfile] = None,
    dtype_bytes: int = 4,
) -> List[Algorithm]:
    """Ascending predicted time under the additive per-kernel model.

    ``profile`` is used *as given* (no hybrid coercion — contrast
    :func:`rank_by_hybrid`); ``None`` falls back to the analytical model
    of the port's kernels on the H100. A bare partially calibrated table may raise
    ``KeyError`` on kernel kinds it has never seen — pass it through the
    ``hybrid`` discriminant if the calibration may be partial.
    """
    return get_discriminant("perfmodel").rank(
        algos, DiscriminantContext(profile=profile, dtype_bytes=dtype_bytes))


def rank_by_hybrid(
    algos: Sequence[Algorithm],
    profile: Optional[KernelProfile] = None,
    dtype_bytes: int = 4,
) -> List[Algorithm]:
    return get_discriminant("hybrid").rank(
        algos, DiscriminantContext(profile=profile, dtype_bytes=dtype_bytes))


def rank_by_measurement(
    algos: Sequence[Algorithm],
    runner=None,
    backend: Optional[str] = None,
) -> List[Algorithm]:
    """Ascending measured time on any registered execution backend.

    ``runner`` is an explicit backend instance; ``backend`` is a registry
    name (``cuda``/``torch``/``blas``/``numpy``). Passing both raises. Default: the
    process-shared ``cuda`` runner (the hand-written kernels, on the
    card). Kernel calls shared between algorithms are timed once
    (deduplicated unique-call benching) rather than per algorithm.
    """
    if runner is not None and backend is not None:
        raise ValueError("pass either runner= or backend=, not both")
    return get_discriminant("measured").rank(
        algos, DiscriminantContext(runner=runner, backend=backend))


def select(
    algos: Sequence[Algorithm],
    discriminant: str = "perfmodel",
    profile: Optional[KernelProfile] = None,
    runner=None,
    dtype_bytes: int = 4,
    backend: Optional[str] = None,
) -> List[Algorithm]:
    """Rank ``algos`` best-first under any registered discriminant.

    ``discriminant`` is a :mod:`repro_torch.core.discriminants` registry key;
    arguments are validated against the policy's capability flags, so a
    ``profile`` handed to ``flops``/``measured``/``roofline`` or a
    ``runner``/``backend`` handed to a policy that never executes kernels
    raises ``ValueError`` instead of being silently ignored. This is the
    single entry point the planner uses; it takes rank 0 of the returned
    list.
    """
    try:
        d = get_discriminant(discriminant)
    except KeyError:
        raise ValueError(
            f"unknown discriminant {discriminant!r}; expected one of "
            f"{registered_discriminants()}") from None
    validate_arguments(d, profile=profile, runner=runner, backend=backend)
    ctx = DiscriminantContext(profile=profile, runner=runner,
                              backend=backend, dtype_bytes=dtype_bytes)
    return d.rank(algos, ctx)


def select_expression(
    expr: str,
    point: Sequence[int],
    discriminant: str = "perfmodel",
    profile: Optional[KernelProfile] = None,
    runner=None,
    dtype_bytes: int = 4,
    backend: Optional[str] = None,
) -> List[Algorithm]:
    """Rank a *registered* expression family's algorithms at one instance.

    ``expr`` is a registry CLI name (``abcd``, ``aatb``, ``abtb``, …, see
    :mod:`repro_torch.core.expressions`); enumeration and ranking both flow from
    the registries, so newly registered families and newly registered
    discriminants are selectable with no further wiring. With a
    measurement-backed discriminant (``measured``/``rankk``), ``backend``
    names the execution backend to time on.
    """
    from .expressions import get_spec
    return select(get_spec(expr).algorithms(point), discriminant,
                  profile=profile, runner=runner, dtype_bytes=dtype_bytes,
                  backend=backend)


_DEPRECATED = {
    "DISCRIMINANTS": lambda: tuple(registered_discriminants()),
}


def __getattr__(name):
    hook = _DEPRECATED.get(name)
    if hook is not None:
        warnings.warn(
            f"selector.{name} is deprecated; call "
            f"repro_torch.core.discriminants.registered_discriminants() "
            f"instead",
            DeprecationWarning, stacklevel=2)
        return hook()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
