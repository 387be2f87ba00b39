"""The port's expression zoo against the JAX package's, on the CPU.

For each of the eight families beyond the paper's two: the registry entry
(name, ndims, description, grids), the enumeration (names, step kinds,
dims, wiring) and the fused-pair decisions must equal ``repro.core``'s
exactly; every algorithm on ``CudaBackend(device="cpu")`` must match the
reference ``PallasBackend`` (Pallas interpret mode — for ``abab`` that
includes the reference's fused ``gemm_syrk_pallas``) on bit-identical
seeded operands, at rtol=1e-4, atol=1e-2 element-wise (the products reach
magnitudes ~1e4, where float32 sums in another order differ by ~1e-3
absolute), as tests/test_torch_sweep.py does for ``aatb`` and ``abcd``.
"""

import numpy as np
import pytest
import torch

from repro.core import algorithms as ref_algorithms
from repro.core import expressions as ref_expressions
from repro.core.backends.base import fusable_pattern as ref_fusable
from repro.core.backends.jax_backend import PallasBackend
from repro_torch.core import algorithms, expressions
from repro_torch.core.backends import (CudaBackend, TorchBackend,
                                       fusable_pattern, operands_from_numpy)
from test_torch_core import _fusions, _norm

TOL = dict(rtol=1e-4, atol=1e-2)

#: The families this slice ports, at small points with distinct dims.
POINTS = {
    "abcde": (60, 130, 70, 90, 50, 40),
    "abtb": (130, 70, 90),
    "btsb": (130, 70),
    "atab": (130, 70, 90),
    "abab": (130, 70, 90),
    "decproj": (8, 130, 70),
    "decattn": (8, 130, 70, 90),
    "decmlp": (8, 130, 70),
}
FAMILIES = sorted(POINTS)


def test_registry_names_descriptions_and_grids_match_reference():
    assert expressions.registered_names() == ref_expressions.registered_names()
    assert set(FAMILIES) | {"aatb", "abcd"} == set(
        expressions.registered_names())
    for name in expressions.registered_names():
        mine = expressions.get_spec(name)
        theirs = ref_expressions.get_spec(name)
        assert (mine.name, mine.ndims, mine.description) == \
            (theirs.name, theirs.ndims, theirs.description)
        assert dict(mine.grids) == dict(theirs.grids)
        for grid in set(expressions.SWEEP_GRIDS) | set(mine.grids):
            assert mine.grid(grid).points() == theirs.grid(grid).points()
        assert expressions.find_spec(mine.name) is mine


@pytest.mark.parametrize("name", FAMILIES)
def test_enumeration_and_fusions_match_reference(name):
    spec, ref_spec = expressions.get_spec(name), ref_expressions.get_spec(name)
    for point in (POINTS[name], spec.grid("smoke").points()[-1]):
        mine, theirs = spec.algorithms(point), ref_spec.algorithms(point)
        assert [_norm(a) for a in mine] == [_norm(a) for a in theirs]
        assert [_fusions(a, fusable_pattern) for a in mine] == \
            [_fusions(a, ref_fusable) for a in theirs]


def test_abab_alg2_is_the_one_fused_gemm_syrk_pair():
    algos = expressions.get_spec("abab").algorithms((1200, 400, 800))
    assert len(algos) == 13
    fused = [a.name for a in algos
             if "gemm+syrk" in _fusions(a, fusable_pattern)]
    assert fused == ["alg2[gemm+syrk+tri2full]"]


@pytest.mark.parametrize("name", FAMILIES)
def test_every_algorithm_matches_pallas_on_identical_operands(name):
    point = POINTS[name]
    ref_backend = PallasBackend(seed=0, tuning=None)
    port = CudaBackend(device="cpu", seed=0)
    ref_algos = ref_expressions.get_spec(name).algorithms(point)
    port_algos = expressions.get_spec(name).algorithms(point)
    assert [a.name for a in port_algos] == [a.name for a in ref_algos]
    for ra, pa in zip(ref_algos, port_algos):
        ref_ops = {k: np.asarray(v) for k, v in
                   ref_backend.make_operands(ra).items()}
        port_ops = port.make_operands(pa)
        assert ref_ops.keys() == port_ops.keys()
        for base, arr in ref_ops.items():   # same seed -> same bits
            np.testing.assert_array_equal(port_ops[base].numpy(), arr)
        want = np.asarray(ref_backend.execute(ra, ref_backend.make_operands(ra)))
        got = port.execute(pa, operands_from_numpy(ref_ops, "cpu"))
        np.testing.assert_allclose(got.numpy(), want, err_msg=pa.name, **TOL)


@pytest.mark.parametrize("name", FAMILIES + ["aatb", "abcd"])
def test_reference_value_equals_every_algorithm(name):
    spec = expressions.get_spec(name)
    point = POINTS.get(name, spec.grid("smoke").points()[-1])
    backend = TorchBackend(device="cpu", seed=3)
    algos = spec.algorithms(point)
    operands = {}
    for alg in algos:
        operands.update(backend.make_operands(alg))
    want = spec.reference_value(point, operands)
    numpy_want = ref_expressions.get_spec(name).reference_value(
        point, {k: v.numpy() for k, v in operands.items()})
    np.testing.assert_allclose(want.numpy(), numpy_want, **TOL)
    for alg in algos:
        got = backend.execute(alg, operands)
        torch.testing.assert_close(got, want, msg=alg.name, **TOL)


@pytest.mark.parametrize("dims", [
    (30, 35, 15, 5, 10, 20, 25), (400, 800, 1200, 600, 1000),
    (10, 20), (7, 3, 9), (1200, 20, 1200, 20)])
def test_optimal_chain_order_matches_reference(dims):
    assert algorithms.optimal_chain_order(dims) == \
        ref_algorithms.optimal_chain_order(dims)
    n = len(dims) - 1
    for order in ([0] * (n - 1), list(range(n - 2, -1, -1))):
        assert algorithms.chain_flops_of_order(dims, order) == \
            ref_algorithms.chain_flops_of_order(dims, order)
    # The DP's optimum is the cheapest of every left-fold order.
    best, _ = algorithms.optimal_chain_order(dims)
    assert best <= algorithms.chain_flops_of_order(dims, [0] * (n - 1))


def test_optimal_chain_order_on_the_classic_instance():
    flops, tree = algorithms.optimal_chain_order((30, 35, 15, 5, 10, 20, 25))
    assert flops == 2 * 15125 and tree == ((0, (1, 2)), ((3, 4), 5))
    with pytest.raises(ValueError, match="empty chain"):
        algorithms.optimal_chain_order((5,))
