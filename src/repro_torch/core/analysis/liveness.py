"""Liveness and dedup soundness over enumerated algorithms.

Two checks:

* **Dead steps** — a step whose output never reaches the algorithm's
  result (the last step's output) is wasted work the enumerator's DCE
  (:func:`repro_torch.core.algorithms._prune_dead_steps`) should have removed;
  one surviving is an enumeration bug → ``dead-step``. The pass computes
  its own live set with the same dependency convention (SYRK and
  TRI2FULL consume only ``lhs``; SYRK's ``rhs`` is the transpose twin,
  same data) and then *cross-checks* against ``_prune_dead_steps``
  itself: if the two disagree on which steps survive, the convention has
  drifted and every FLOP total downstream is suspect →
  ``prune-divergence``.

* **Family dedup** — :func:`repro_torch.core.algorithms.canonical_key` is the
  identity enumeration dedups on; two algorithms in one family sharing a
  key means dedup is unsound (the step-id-shift bug class) →
  ``duplicate-key``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

from ..algorithms import Algorithm, Step, _prune_dead_steps, canonical_key
from .findings import Collector


def _step_deps(step: Step) -> Tuple[object, ...]:
    """Data dependencies of a step (the _prune_dead_steps convention)."""
    if step.call.kind in ("syrk", "tri2full"):
        return (step.lhs,)
    return (step.lhs, step.rhs)


def live_out_ids(steps: Sequence[Step]) -> Set[int]:
    """Output ids reachable from the result (the last step's output)."""
    if not steps:
        return set()
    live: Set[int] = {steps[-1].out}
    for step in reversed(steps):
        if step.out not in live:
            continue
        live.update(d for d in _step_deps(step) if isinstance(d, int))
    return live


def check_liveness(algo: Algorithm, collector: Collector) -> None:
    """Emit ``dead-step`` per unreachable step + the DCE cross-check."""
    steps = algo.steps
    if not steps:
        return
    live = live_out_ids(steps)
    dead = [(i, s) for i, s in enumerate(steps) if s.out not in live]
    for i, step in dead:
        collector.emit(
            "dead-step",
            f"{step.call.kind} output {step.out} never reaches the result "
            f"(out={steps[-1].out}); the enumerator's DCE should have "
            f"pruned it",
            step_index=i, step_out=step.out)
    # Cross-check: the enumerator's own pruner must agree on the
    # surviving set, else the dependency convention has drifted between
    # enumeration and analysis.
    pruned = _prune_dead_steps(steps, steps[-1].out)
    pruned_ids = [s.out for s in pruned]
    expected_ids = [s.out for s in steps if s.out in live]
    if pruned_ids != expected_ids:
        collector.emit(
            "prune-divergence",
            f"liveness keeps outputs {expected_ids} but "
            f"_prune_dead_steps keeps {pruned_ids}")


def check_family_dedup(algos: Sequence[Algorithm],
                       collector: Collector) -> None:
    """Emit ``duplicate-key`` for every canonical-key collision."""
    seen: Dict[Tuple[object, ...], str] = {}
    for algo in algos:
        try:
            key = canonical_key(algo.steps)
        except KeyError:
            # Renumbering hit a dangling step ref; the per-algorithm
            # pass already reported it, and no key means no collision.
            continue
        first = seen.get(key)
        if first is not None:
            collector.emit(
                "duplicate-key",
                f"algorithms {first!r} and {algo.name!r} share a canonical "
                f"key: enumeration dedup is unsound for this family")
        else:
            seen[key] = algo.name


def duplicate_key_groups(
        algos: Sequence[Algorithm]) -> List[List[str]]:
    """Names of algorithms grouped by shared canonical key (audit API)."""
    groups: Dict[Tuple[object, ...], List[str]] = {}
    for algo in algos:
        try:
            key = canonical_key(algo.steps)
        except KeyError:
            continue
        groups.setdefault(key, []).append(algo.name)
    return [names for names in groups.values() if len(names) > 1]
