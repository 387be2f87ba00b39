"""The autotuner's measurement loop: time pruned survivors, keep winners.

The port's counterpart of the reference package's ``kernels/autotune.py``.
:mod:`repro_torch.core.tuning` decides *what* deserves timing (the
kernel's own candidates, the shared-memory rule and its cost model);
this module spends the measurement budget. Per ``(kind, dims)`` request:

1. prune the candidates (:func:`~repro_torch.core.tuning.prune_candidates`
   at the backend's card): survivors arrive cheapest-modeled first with
   the model's pick always among them;
2. time each survivor through the backend's ``time_algorithm`` — base
   kinds as a :func:`~repro_torch.core.backends.synthetic_algorithm`,
   fused kinds as a
   :func:`~repro_torch.core.backends.synthetic_fused_algorithm` — with
   the candidate injected by
   :meth:`~repro_torch.core.backends.CudaBackend.tuning_override`, the
   lookup production dispatch uses; on a card each candidate is one
   captured CUDA graph, replayed;
3. record the fastest measured launch as a
   :class:`~repro_torch.core.tuning.TunedEntry`.

The reference also probes the Mosaic ``dimension_semantics`` knob of its
GEMM on the winning tile; a Hopper launch has no such knob, so there is
no probe here. Operands are synthesized once per request and shared by
every candidate, so candidates race on identical data.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core.backends.base import synthetic_algorithm, synthetic_fused_algorithm
from ..core.flops import KernelCall
from ..core.tuning import (
    TUNABLE_KINDS,
    TunedEntry,
    TuningTable,
    card_limits,
    prune_candidates,
)


def _request_algorithm(kind: str, dims: Sequence[int]):
    if kind in ("chain_gemm", "gemm_syrk"):
        return synthetic_fused_algorithm(kind, dims)
    return synthetic_algorithm(KernelCall(kind, tuple(dims)))


def autotune_request(
    backend,
    kind: str,
    dims: Sequence[int],
    *,
    reps: Optional[int] = None,
    budget: int = 8,
    slack: float = 2.0,
) -> TunedEntry:
    """Tune one ``(kind, dims)``: prune, time survivors, return the winner.

    ``budget`` caps how many configs reach the timer; ``slack`` is the
    cost model's rejection threshold. ``backend`` must expose
    ``tuning_override`` (a ``CudaBackend``): what is measured is exactly
    what a table hit later runs.
    """
    dims = tuple(int(d) for d in dims)
    report = prune_candidates(kind, dims,
                              limits=card_limits(backend.device),
                              slack=slack, budget=budget)
    alg = _request_algorithm(kind, dims)
    operands = backend.make_operands(alg)

    timed: List[Tuple[float, Dict[str, int]]] = []
    default_seconds = None
    for config in report.survivors:
        with backend.tuning_override({(kind, dims): config}):
            seconds = backend.time_algorithm(alg, operands, reps=reps)
        timed.append((seconds, config))
        if config == report.default:
            default_seconds = seconds
    best_seconds, best_config = min(timed, key=lambda e: e[0])
    return TunedEntry(
        config=dict(best_config),
        seconds=float(best_seconds),
        default_seconds=float(default_seconds),
        timed=len(timed),
        pruned=len(report.rejected),
    )


def autotune(
    backend,
    requests: Sequence[Tuple[str, Sequence[int]]],
    *,
    reps: Optional[int] = None,
    budget: int = 8,
    slack: float = 2.0,
    progress=None,
) -> TuningTable:
    """Tune every ``(kind, dims)`` request into one :class:`TuningTable`."""
    table = TuningTable()
    for i, (kind, dims) in enumerate(requests):
        entry = autotune_request(backend, kind, dims, reps=reps,
                                 budget=budget, slack=slack)
        table.set(kind, dims, entry)
        if progress is not None:
            progress(i + 1, len(requests), kind, tuple(dims), entry)
    return table


def default_tune_requests(
    calls: Sequence[KernelCall],
    fused_dims: Sequence[int] = (),
) -> List[Tuple[str, Tuple[int, ...]]]:
    """Tuning requests for a calibration grid's calls + fused diagonals.

    Base kinds come straight from the grid (minus ``tri2full``, which has
    no launch knob); the fused patterns have no
    :class:`~repro_torch.core.flops.KernelCall`, so each ``d`` in
    ``fused_dims`` contributes the square shapes ``chain_gemm (d,d,d,d)``
    and ``gemm_syrk (d,d,d)``.
    """
    requests: List[Tuple[str, Tuple[int, ...]]] = []
    seen = set()
    for call in calls:
        key = (call.kind, call.dims)
        if call.kind in TUNABLE_KINDS and key not in seen:
            seen.add(key)
            requests.append(key)
    for d in fused_dims:
        d = int(d)
        for key in (("chain_gemm", (d, d, d, d)), ("gemm_syrk", (d, d, d))):
            if key not in seen:
                seen.add(key)
                requests.append(key)
    return requests
