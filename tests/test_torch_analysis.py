"""The port's static plan verifier against the JAX package's, on the CPU.

``repro_torch.core.analysis`` is the port's own copy of
``repro.core.analysis``: the same 13 rules, the same zoo lint (every
algorithm of every family over the ``smoke`` and ``small`` grids, 27,874
algorithms, zero findings), the same mutation suite, and the same
``REPRO_VERIFY_ENUMERATION`` debug hook. These are counts, rule ids and
decisions, so they compare exactly.
"""

import os
import pathlib
import subprocess
import sys

import pytest

from repro.core import analysis as ref_analysis
from repro_torch.core import algorithms, analysis, expressions
from repro_torch.core.analysis import AnalysisError
from repro_torch.core.flops import gemm, symm, syrk, tri2full

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_rule_registry_matches_reference():
    assert len(analysis.RULES) == 13
    assert {r: (v.severity, v.summary) for r, v in analysis.RULES.items()} \
        == {r: (v.severity, v.summary)
            for r, v in ref_analysis.RULES.items()}


def test_zoo_lint_matches_reference_and_is_clean():
    mine = analysis.verify_zoo(grids=("smoke", "small"))
    theirs = ref_analysis.verify_zoo(grids=("smoke", "small"))
    assert [(r.family, r.grid, r.instances, r.algorithms)
            for r in mine.rows] == \
        [(r.family, r.grid, r.instances, r.algorithms) for r in theirs.rows]
    assert (mine.algorithms, mine.instances, mine.rules_run) == \
        (27874, 2398, 13)
    assert mine.findings == [] and theirs.findings == []


@pytest.mark.parametrize("spec,point", [("aatb", None), ("atab", (96, 64, 48)),
                                        ("abtb", (96, 64, 48))])
def test_mutation_suite_catches_what_the_reference_catches(spec, point):
    mine = analysis.run_mutation_suite(spec, point)
    theirs = ref_analysis.run_mutation_suite(spec, point)
    assert [(o.mutant, o.expected_rule, o.fired_rules, o.caught)
            for o in mine] == \
        [(o.mutant, o.expected_rule, o.fired_rules, o.caught)
         for o in theirs]
    assert analysis.mutation_catch_rate(mine) == \
        ref_analysis.mutation_catch_rate(theirs)
    if spec == "aatb":
        assert analysis.mutation_catch_rate(mine) == (8, 8)


@pytest.mark.parametrize("call", [gemm(30, 20, 10), syrk(30, 10),
                                  symm(30, 20), tri2full(30)])
def test_flop_recount_matches_kernel_count_and_reference(call):
    from repro.core.flops import KernelCall as RefCall
    assert analysis.recount_call(call) == call.flops == \
        ref_analysis.recount_call(RefCall(call.kind, call.dims))


def test_verify_enumeration_hook_bypasses_the_cache_and_raises(monkeypatch):
    spec = expressions.get_spec("abab")
    point = (24, 36, 12)
    monkeypatch.delenv(algorithms.VERIFY_ENUMERATION_ENV, raising=False)
    expressions.clear_algorithm_cache()
    names = [a.name for a in spec.algorithms(point)]
    assert expressions.algorithm_cache_stats() == (0, 1)
    assert spec.verify(point) == []

    monkeypatch.setenv(algorithms.VERIFY_ENUMERATION_ENV, "1")
    assert [a.name for a in spec.algorithms(point)] == names
    assert expressions.algorithm_cache_stats() == (1, 1)  # verify's lookup
    # Plant a bad enumeration: dead transpose-twin steps are kept.
    monkeypatch.setattr(algorithms, "_prune_dead_steps",
                        lambda steps, final: steps)
    with pytest.raises(AnalysisError, match="dead-step"):
        spec.algorithms(point)
    with pytest.raises(AnalysisError):
        algorithms.enumerate_algorithms(spec.chain(point), verify=True)
    assert expressions.algorithm_cache_stats() == (1, 1)  # cache bypassed

    monkeypatch.delenv(algorithms.VERIFY_ENUMERATION_ENV)
    assert [a.name for a in spec.algorithms(point)] == names  # cached, clean
    assert algorithms.enumerate_algorithms(spec.chain(point), verify=False)


def test_cli_lints_the_zoo_and_runs_the_mutants():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.core.analysis"]
    zoo = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert zoo.returncode == 0, zoo.stdout + zoo.stderr
    assert zoo.stdout.splitlines()[-1].startswith(
        "zoo lint: 27874 algorithm(s) over 2398 instance(s), 13 rules, "
        "0 finding(s)")
    mutants = subprocess.run(cmd + ["--mutants"], env=env,
                             capture_output=True, text=True, timeout=300)
    assert mutants.returncode == 0, mutants.stdout + mutants.stderr
    assert mutants.stdout.splitlines()[-1] == \
        "mutation suite (aatb): 8/8 caught"
    helped = subprocess.run(cmd + ["--help"], env=env, capture_output=True,
                            text=True, timeout=300)
    assert all(rule in helped.stdout for rule in analysis.RULES)
