"""Mutation-testing harness: prove the verifier catches known bug classes.

A static checker that has never seen a broken DAG is untested in the
only way that matters. This module corrupts *valid* enumerated families
in eight known ways — each modelled on a real or realistic enumeration
bug — and asserts that :func:`~repro_torch.core.analysis.verify.
verify_algorithms` flags each one with the *expected* rule:

==========================  ====================  =========================
mutant                      expected rule         modelled failure
==========================  ====================  =========================
``swapped-dims``            ``shape-mismatch``    m/k transposed in a call
``dropped-tri2full``        ``raw-tri-read``      raw reads of a
                                                  tri-stored SYRK out
``dangling-step-ref``       ``dangling-ref``      consumer wired to an id
                                                  that is never produced
``flop-off-by-one``         ``flop-mismatch``     a lying FLOP formula
``dead-step``               ``dead-step``         DCE failed to prune
``duplicate-canonical-key`` ``duplicate-key``     dedup let a twin survive
``wrong-symm-side``         ``wrong-symm-side``   side-L/R flag flipped
``stale-out-id``            ``stale-out-id``      output id collision
==========================  ====================  =========================

The harness mutates a family that exercises every kernel kind (default:
``aatb`` — SYRK, TRI2FULL, SYMM and GEMM all appear) at a point with
pairwise-distinct dims, so no mutation is accidentally a no-op.
``python -m repro_torch.core.analysis --mutants`` exits 0 only on 8/8
caught.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from ..algorithms import Algorithm, Step
from ..expressions import get_spec
from ..flops import KernelCall
from .verify import verify_algorithms

#: Default mutation target: family exercising all four kernel kinds.
DEFAULT_SPEC = "aatb"
#: Pairwise-distinct dims so dim swaps can never be symmetric no-ops.
DEFAULT_POINT: Tuple[int, ...] = (96, 64, 48)


class _OffByOneFlops(KernelCall):
    """A KernelCall whose claimed FLOPs are off by one (a lying formula)."""

    @property
    def flops(self) -> int:
        return super().flops + 1


Mutator = Callable[[List[Algorithm]], List[Algorithm]]


@dataclasses.dataclass(frozen=True)
class MutantClass:
    """One named corruption + the rule the verifier must answer with."""

    name: str
    expected_rule: str
    description: str
    apply: Mutator


@dataclasses.dataclass(frozen=True)
class MutationOutcome:
    """Result of running one mutant through the verifier."""

    mutant: str
    expected_rule: str
    fired_rules: Tuple[str, ...]
    caught: bool


def _replace_step(algo: Algorithm, index: int, step: Step) -> Algorithm:
    steps = list(algo.steps)
    steps[index] = step
    return Algorithm(name=algo.name, steps=tuple(steps))


def _find_step(algos: Sequence[Algorithm],
               pred: Callable[[Algorithm, int, Step], bool]
               ) -> Tuple[int, int]:
    for ai, algo in enumerate(algos):
        for si, step in enumerate(algo.steps):
            if pred(algo, si, step):
                return ai, si
    raise LookupError(
        "no step in the family matches this mutant's precondition — "
        "choose a family that exercises the targeted kernel pattern")


def _mutate_swapped_dims(algos: List[Algorithm]) -> List[Algorithm]:
    """Transpose m and k of a GEMM whose m != k."""
    ai, si = _find_step(
        algos, lambda a, i, s: s.call.kind == "gemm"
        and s.call.dims[0] != s.call.dims[2])
    algo = algos[ai]
    step = algo.steps[si]
    m, n, k = step.call.dims
    bad = dataclasses.replace(step, call=dataclasses.replace(
        step.call, dims=(k, n, m)))
    out = list(algos)
    out[ai] = _replace_step(algo, si, bad)
    return out


def _mutate_dropped_tri2full(algos: List[Algorithm]) -> List[Algorithm]:
    """Delete a mid-DAG TRI2FULL and wire its consumers to the raw out."""
    ai, si = _find_step(
        algos, lambda a, i, s: s.call.kind == "tri2full"
        and any(isinstance(r, int) and r == s.out
                for later in a.steps[i + 1:] for r in (later.lhs, later.rhs)))
    algo = algos[ai]
    dropped = algo.steps[si]
    steps: List[Step] = []
    for step in algo.steps:
        if step is dropped:
            continue
        lhs = dropped.lhs if step.lhs == dropped.out else step.lhs
        rhs = dropped.lhs if step.rhs == dropped.out else step.rhs
        steps.append(dataclasses.replace(step, lhs=lhs, rhs=rhs))
    out = list(algos)
    out[ai] = Algorithm(name=algo.name, steps=tuple(steps))
    return out


def _mutate_dangling_ref(algos: List[Algorithm]) -> List[Algorithm]:
    """Point a consumer at a step output that is never produced."""
    ai, si = _find_step(algos, lambda a, i, s: isinstance(s.lhs, int))
    algo = algos[ai]
    step = algo.steps[si]
    bogus = max(s.out for s in algo.steps) + 1_000_000
    out = list(algos)
    out[ai] = _replace_step(algo, si,
                            dataclasses.replace(step, lhs=bogus))
    return out


def _mutate_flop_off_by_one(algos: List[Algorithm]) -> List[Algorithm]:
    """Swap one call for a subclass whose claimed FLOPs are +1."""
    ai, si = _find_step(algos, lambda a, i, s: s.call.kind != "tri2full")
    algo = algos[ai]
    step = algo.steps[si]
    lying = _OffByOneFlops(kind=step.call.kind, dims=step.call.dims,
                           operands=step.call.operands)
    out = list(algos)
    out[ai] = _replace_step(algo, si,
                            dataclasses.replace(step, call=lying))
    return out


def _mutate_dead_step(algos: List[Algorithm]) -> List[Algorithm]:
    """Insert an unconsumed duplicate of an early step before the result."""
    ai, si = _find_step(algos, lambda a, i, s: len(a.steps) >= 1)
    algo = algos[ai]
    donor = algo.steps[si]
    fresh = max(s.out for s in algo.steps) + 1
    steps = list(algo.steps)
    steps.insert(len(steps) - 1 if len(steps) > 1 else 0,
                 dataclasses.replace(donor, out=fresh))
    out = list(algos)
    out[ai] = Algorithm(name=algo.name, steps=tuple(steps))
    return out


def _mutate_duplicate_key(algos: List[Algorithm]) -> List[Algorithm]:
    """Append a renamed copy of the first algorithm (dedup escapee)."""
    first = algos[0]
    return list(algos) + [
        Algorithm(name=f"dup[{first.name}]", steps=first.steps)]


def _mutate_wrong_symm_side(algos: List[Algorithm]) -> List[Algorithm]:
    """Flip a SYMM step's side flag (executors would read the wrong op)."""
    ai, si = _find_step(algos, lambda a, i, s: s.call.kind == "symm")
    algo = algos[ai]
    step = algo.steps[si]
    flipped = "R" if step.symm_side == "L" else "L"
    out = list(algos)
    out[ai] = _replace_step(
        algo, si, dataclasses.replace(step, symm_side=flipped))
    return out


def _mutate_stale_out_id(algos: List[Algorithm]) -> List[Algorithm]:
    """Collide the final step's output id with an earlier step's."""
    ai, _ = _find_step(algos, lambda a, i, s: len(a.steps) >= 2)
    algo = algos[ai]
    steps = list(algo.steps)
    steps[-1] = dataclasses.replace(steps[-1], out=steps[0].out)
    out = list(algos)
    out[ai] = Algorithm(name=algo.name, steps=tuple(steps))
    return out


MUTANT_CLASSES: Tuple[MutantClass, ...] = (
    MutantClass("swapped-dims", "shape-mismatch",
                "GEMM call dims with m and k transposed",
                _mutate_swapped_dims),
    MutantClass("dropped-tri2full", "raw-tri-read",
                "tri-stored SYRK output consumed raw",
                _mutate_dropped_tri2full),
    MutantClass("dangling-step-ref", "dangling-ref",
                "consumer wired to a never-produced output id",
                _mutate_dangling_ref),
    MutantClass("flop-off-by-one", "flop-mismatch",
                "kernel call whose claimed FLOPs are off by one",
                _mutate_flop_off_by_one),
    MutantClass("dead-step", "dead-step",
                "unconsumed step the enumerator's DCE should have pruned",
                _mutate_dead_step),
    MutantClass("duplicate-canonical-key", "duplicate-key",
                "two family members sharing one canonical key",
                _mutate_duplicate_key),
    MutantClass("wrong-symm-side", "wrong-symm-side",
                "SYMM side flag flipped relative to its operands",
                _mutate_wrong_symm_side),
    MutantClass("stale-out-id", "stale-out-id",
                "final step redefining an earlier step's output id",
                _mutate_stale_out_id),
)


def mutant_names() -> List[str]:
    return [m.name for m in MUTANT_CLASSES]


def run_mutation_suite(
    spec_name: str = DEFAULT_SPEC,
    point: Optional[Sequence[int]] = None,
) -> List[MutationOutcome]:
    """Apply every mutant to a fresh valid family; report catch status.

    A mutant is *caught* iff its expected rule id is among the rules the
    verifier fired on the corrupted family (other rules may fire too —
    corruption cascades are fine; silence is not).
    """
    spec = get_spec(spec_name)
    pt: Tuple[int, ...] = tuple(point) if point is not None else DEFAULT_POINT
    chain = spec.chain(pt)
    outcomes: List[MutationOutcome] = []
    for mutant in MUTANT_CLASSES:
        algos = spec.algorithms(pt)
        baseline = verify_algorithms(algos, chain=chain)
        if baseline:
            raise AssertionError(
                f"mutation harness needs a clean baseline; {spec_name}@"
                f"{pt} already has findings: {baseline}")
        mutated = mutant.apply(algos)
        fired = tuple(sorted({
            f.rule_id for f in verify_algorithms(mutated, chain=chain)}))
        outcomes.append(MutationOutcome(
            mutant=mutant.name,
            expected_rule=mutant.expected_rule,
            fired_rules=fired,
            caught=mutant.expected_rule in fired))
    return outcomes


def mutation_catch_rate(
        outcomes: Sequence[MutationOutcome]) -> Tuple[int, int]:
    """(caught, total) over a suite run."""
    return sum(1 for o in outcomes if o.caught), len(outcomes)
