"""Static plan verifier: analysis passes over algorithm step-DAGs.

The PyTorch port's own copy of the reference package's
``core/analysis/`` (the reference's rule catalog, passes and mutants).

Nothing in this package executes a kernel. Every check is over the
*declared* structure of an :class:`~repro_torch.core.algorithms.Algorithm` —
shapes, storage tags, step wiring, FLOP claims — so it can run over the
whole expression zoo in seconds, inside enumeration (the
``REPRO_VERIFY_ENUMERATION`` debug hook) and from the command line.

Entry points::

    from repro_torch.core.analysis import verify_algorithm, verify_family

    findings = verify_family("atab", (64, 96))
    assert not findings

CLI::

    python -m repro_torch.core.analysis              # lint the whole zoo
    python -m repro_torch.core.analysis --mutants    # mutation-catch gate

Extension points (new kernel kinds plug in here): per-kind shape rules
(:func:`register_kernel_shape`), read modes
(:func:`register_kernel_reads`), FLOP nodes
(:func:`register_flop_node`), and lint rules (:func:`register_rule`).
"""

from __future__ import annotations

from .findings import (
    AnalysisError,
    Collector,
    Finding,
    Rule,
    RULES,
    errors_only,
    format_findings,
    register_rule,
    registered_rules,
)
from .flopcheck import (
    recount_call,
    register_flop_node,
    registered_flop_kinds,
)
from .liveness import duplicate_key_groups, live_out_ids
from .mutants import (
    MUTANT_CLASSES,
    MutantClass,
    MutationOutcome,
    mutant_names,
    mutation_catch_rate,
    run_mutation_suite,
)
from .shapes import ValueInfo, infer_shapes, register_kernel_shape
from .storage import register_kernel_reads, registered_read_kinds
from .verify import (
    FamilyLint,
    ZooLint,
    assert_algorithms_valid,
    verify_algorithm,
    verify_algorithms,
    verify_family,
    verify_zoo,
)

__all__ = [
    "AnalysisError",
    "Collector",
    "FamilyLint",
    "Finding",
    "MUTANT_CLASSES",
    "MutantClass",
    "MutationOutcome",
    "RULES",
    "Rule",
    "ValueInfo",
    "ZooLint",
    "assert_algorithms_valid",
    "duplicate_key_groups",
    "errors_only",
    "format_findings",
    "infer_shapes",
    "live_out_ids",
    "mutant_names",
    "mutation_catch_rate",
    "recount_call",
    "register_flop_node",
    "register_kernel_reads",
    "register_kernel_shape",
    "register_rule",
    "registered_flop_kinds",
    "registered_read_kinds",
    "registered_rules",
    "run_mutation_suite",
    "verify_algorithm",
    "verify_algorithms",
    "verify_family",
    "verify_zoo",
]
