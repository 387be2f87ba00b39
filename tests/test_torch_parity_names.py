"""Four small public names of the reference's, in the port, on the CPU.

``GridSpec.named`` (the same grid points and the same error text),
``SPECS`` (the registry under its older name, re-exported by the sweep
module), ``configs.all_cells`` (the same 40-cell table with its skip
reasons) and ``ExecutionBackend.num_inputs`` (the built callable's arity),
each against the reference package's result.
"""

import pytest

from repro import configs as ref_configs
from repro.core import expressions as ref_expressions
from repro.core import sweep as ref_sweep
from repro.core.backends import get_backend as ref_get_backend
from repro_torch import configs
from repro_torch.core import expressions
from repro_torch.core import sweep
from repro_torch.core.backends import (CudaBackend, TorchBackend,
                                       register_torch_backends)
from repro_torch.core.backends.base import get_backend


@pytest.mark.parametrize("name", sorted(ref_expressions.SWEEP_GRIDS))
@pytest.mark.parametrize("ndims", [1, 2, 3])
def test_gridspec_named_equals_reference(name, ndims):
    mine = expressions.GridSpec.named(name, ndims)
    theirs = ref_expressions.GridSpec.named(name, ndims)
    assert (mine.name, mine.axes) == (theirs.name, theirs.axes)
    assert mine.points() == theirs.points()
    assert mine.n_points == len(expressions.SWEEP_GRIDS[name]) ** ndims


def test_gridspec_named_unknown_grid_raises_the_reference_text():
    with pytest.raises(ValueError) as mine:
        expressions.GridSpec.named("nope", 3)
    with pytest.raises(ValueError) as theirs:
        ref_expressions.GridSpec.named("nope", 3)
    assert str(mine.value) == str(theirs.value)


def test_specs_is_the_registry_and_the_sweep_reexports_it():
    assert expressions.SPECS is expressions.REGISTRY
    assert sweep.SPECS is expressions.SPECS
    assert sorted(expressions.SPECS) == sorted(ref_sweep.SPECS)
    for key, spec in expressions.SPECS.items():
        assert spec.name == ref_sweep.SPECS[key].name


def test_all_cells_equals_the_reference_table():
    cells = configs.all_cells()
    assert cells == ref_configs.all_cells()
    assert len(cells) == 40
    skipped = [(a, s) for a, s, run, _ in cells if not run]
    assert len(skipped) == 8 and all(s == "long_500k" for _, s in skipped)


@pytest.mark.parametrize("name", ["aatb", "abcd", "abab", "decattn"])
def test_num_inputs_method_equals_reference(name):
    register_torch_backends()
    ref = ref_get_backend("jax")
    point = expressions.get_spec(name).grid("smoke").points()[-1]
    mine = expressions.get_spec(name).algorithms(point)
    theirs = ref_expressions.get_spec(name).algorithms(point)
    for be in (TorchBackend(device="cpu"), CudaBackend(device="cpu"),
               get_backend("blas", flush_cache=False)):
        assert [be.num_inputs(a) for a in mine] == \
            [ref.num_inputs(a) for a in theirs]
