"""The port's framework-neutral core against the JAX package's.

Enumeration, FLOP counts, fusion decisions and anomaly classification of
``repro_torch.core`` must equal ``repro.core``'s exactly (no tolerance:
these are integers, names and decisions). Also: the port imports neither
JAX nor the reference package, and never falls back quietly to the CPU.
"""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro.core import anomaly as ref_anomaly
from repro.core import expressions as ref_expressions
from repro.core.backends import base as ref_base
from repro.core.backends.base import fusable_pattern as ref_fusable
from repro_torch.core import anomaly, expressions
from repro_torch.core.backends import (CudaBackend, TorchBackend,
                                       fusable_pattern, num_inputs,
                                       synthetic_algorithm)
from repro_torch.core.flops import KernelCall

ROOT = pathlib.Path(__file__).resolve().parents[1]

POINTS = [
    ("aatb", (1200, 800, 400)), ("aatb", (32, 64, 96)), ("aatb", (70, 70, 70)),
    ("aatb", (5, 300, 2)), ("abcd", (400, 800, 1200, 600, 1000)),
    ("abcd", (32, 64, 96, 128, 32)), ("abcd", (7, 7, 7, 7, 7)),
    ("abcd", (1200, 400, 1200, 400, 1200)),
]


def _ref(r):
    if isinstance(r, int) or r is None:
        return r
    return ("leaf", r.index, r.base, r.transposed, r.rows, r.cols,
            r.symmetric, r.storage)


def _norm(alg):
    return (alg.name, alg.flops, tuple(
        (s.call.kind, s.call.dims, s.call.flops, s.symm_side, s.out,
         s.out_rows, s.out_cols, s.out_storage, s.out_symmetric,
         _ref(s.lhs), _ref(s.rhs))
        for s in alg.steps))


def _fusions(alg, fusable):
    steps = alg.steps
    return tuple(fusable(steps[i], steps[i + 1], steps[i + 2:])
                 for i in range(len(steps) - 1))


@pytest.mark.parametrize("name,point", POINTS)
def test_enumeration_matches_reference(name, point):
    mine = expressions.get_spec(name).algorithms(point)
    theirs = ref_expressions.get_spec(name).algorithms(point)
    assert [_norm(a) for a in mine] == [_norm(a) for a in theirs]
    assert [_fusions(a, fusable_pattern) for a in mine] == \
        [_fusions(a, ref_fusable) for a in theirs]


def test_paper_algorithm_sets_and_fusable_pairs():
    aatb = expressions.get_spec("aatb").algorithms((1200, 800, 400))
    assert [a.name for a in aatb] == [
        "alg1[syrk+symm]", "alg2[syrk+tri2full+gemm]", "alg3[gemm+symm]",
        "alg4[gemm+gemm]", "alg5[gemm+gemm]"]
    assert [_fusions(a, fusable_pattern) for a in aatb][3] == ("gemm+gemm",)
    abcd = expressions.get_spec("abcd").algorithms((400, 800, 1200, 600, 1000))
    assert len(abcd) == 6
    assert sum("gemm+gemm" in _fusions(a, fusable_pattern) for a in abcd) == 4


def test_registry_and_grids_match_reference():
    assert expressions.registered_names() == ["aatb", "abcd"]
    for name in expressions.registered_names():
        mine, theirs = expressions.get_spec(name), ref_expressions.get_spec(name)
        assert (mine.name, mine.ndims) == (theirs.name, theirs.ndims)
        for grid in expressions.SWEEP_GRIDS:
            assert mine.grid(grid).points() == theirs.grid(grid).points()
    with pytest.raises(ValueError, match="takes 3 dims"):
        expressions.get_spec("aatb").algorithms((1, 2))


@pytest.mark.parametrize("call", [
    KernelCall("gemm", (30, 20, 10)), KernelCall("syrk", (30, 10)),
    KernelCall("symm", (30, 20)), KernelCall("tri2full", (30,))])
def test_one_kernel_benchmarks_match_reference_and_run(call):
    from repro.core.flops import KernelCall as RefCall
    mine = synthetic_algorithm(call)
    theirs = ref_base.synthetic_algorithm(RefCall(call.kind, call.dims))
    assert _norm(mine) == _norm(theirs)
    assert num_inputs(mine) == ref_base.num_inputs(theirs)
    backend = CudaBackend(device="cpu", reps=2, seed=0)
    operands = backend.make_operands(mine)
    built = backend.build(mine)(*(operands[i] for i in range(num_inputs(mine))))
    assert torch.equal(built, backend.execute(mine, operands))
    assert backend.benchmark_call(call) > 0


CLASSIFY_CASES = [
    ({"a": 1.0, "b": 2.0}, {"a": 10, "b": 5}, 0.10),          # anomaly
    ({"a": 1.0, "b": 1.05}, {"a": 10, "b": 5}, 0.10),         # below threshold
    ({"a": 1.0, "b": 1.0, "c": 3.0}, {"a": 5, "b": 5, "c": 1}, 0.05),
    ({"a": 0.0, "b": 0.0}, {"a": 0, "b": 0}, 0.10),           # zero denominators
    ({"a": 2.0, "b": 1.0, "c": 1.0}, {"a": 4, "b": 8, "c": 6}, 0.10),
]


@pytest.mark.parametrize("times,flops,threshold", CLASSIFY_CASES)
def test_classify_matches_reference(times, flops, threshold):
    mine = anomaly.classify(times, flops, threshold=threshold)
    theirs = ref_anomaly.classify(times, flops, threshold=threshold)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def test_regions_and_summary_match_reference():
    axes = [(1, 2, 3, 5, 8)] * 2
    scores = {(1, 1): (0.5, 0.1), (1, 2): (0.2, 0.3), (2, 2): (0.4, 0.0),
              (8, 8): (0.9, 0.9), (5, 1): (0.11, 0.2), (5, 2): (0.3, 0.1),
              (3, 8): (0.2, 0.2)}
    mine = anomaly.cluster_regions(scores, axes)
    theirs = ref_anomaly.cluster_regions(scores, axes)
    assert [dataclasses.asdict(r) for r in mine] == \
        [dataclasses.asdict(r) for r in theirs]
    assert anomaly.region_summary(mine, 25) == \
        ref_anomaly.region_summary(theirs, 25)
    with pytest.raises(ValueError, match="off-grid"):
        anomaly.cluster_regions({(4, 1): (0.1, 0.1)}, axes)


def test_port_imports_no_jax_and_nothing_of_the_reference():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax_and_no_reference_module():
    pattern = re.compile(
        r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)\b(?!_torch))",
        re.MULTILINE)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the backends rightly use it")
    for cls in (CudaBackend, TorchBackend):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
    assert CudaBackend(device="cpu").fingerprint().device == "cpu"


def test_float32_label_only_and_tf32_off():
    with pytest.raises(ValueError, match="measures float32"):
        CudaBackend(device="cpu", dtype="float64")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        TorchBackend(device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
