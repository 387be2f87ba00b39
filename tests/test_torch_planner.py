"""The port's planner against the reference's, on the CPU.

Counterparts of the planner tests of tests/test_core.py and
tests/test_calibrate.py: for every family of the zoo at three seeded
points, ``Planner(discriminant="flops")`` picks the same algorithm and
ranks the same order as ``repro.core.planner.Planner`` on ``numpy``;
``Plan.fn`` on the port's CPU backends equals the reference's on the same
seeded operands (float32 against float64, at tests/test_torch_zoo.py's
tolerance, rtol 1e-4, atol 1e-2); ``perfmodel`` under one shared table
of seeded times picks the same in both; and ``observe`` apportions a
timing over a plan's calls the same way in both.
"""

import numpy as np
import pytest
import torch

from repro.core import perfmodel as ref_perfmodel
from repro.core import planner as ref_planner
from repro.core.backends import get_backend as ref_get_backend
from repro.core.expressions import get_spec as ref_get_spec
from repro_torch.core import planner
from repro_torch.core.backends import TorchBackend
from repro_torch.core.discriminants import as_hybrid
from repro_torch.core.expressions import get_spec, registered_names
from repro_torch.core.flops import KernelCall
from repro_torch.core.perfmodel import (AnalyticalHopperProfile,
                                        HybridProfile, TableProfile)
from repro_torch.core.profile_store import current_fingerprint, save_profile

FAMILIES = registered_names()
TOL = dict(rtol=1e-4, atol=1e-2)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path / "profiles"))
    planner.reset_default_planner()
    ref_planner.reset_default_planner()
    yield
    planner.reset_default_planner()
    ref_planner.reset_default_planner()


def _points(name):
    """Three seeded points of the family, dims in [8, 96]."""
    spec = get_spec(name)
    rng = np.random.default_rng(FAMILIES.index(name))
    return [tuple(int(d) for d in rng.integers(8, 97, spec.ndims))
            for _ in range(3)]


def _tables(name, point, seed):
    """The same seeded time for every call of every algorithm at
    ``point``, as a table of each package."""
    rng = np.random.default_rng(seed)
    calls = sorted({(c.kind, c.dims) for a in get_spec(name).algorithms(point)
                    for c in a.calls})
    times = {key: float(rng.uniform(1e-5, 1e-3)) for key in calls}
    return (TableProfile(peak_flops=1e12, table=dict(times)),
            ref_perfmodel.TableProfile(peak_flops=1e12, table=dict(times)))


@pytest.mark.parametrize("name", FAMILIES)
def test_flops_planner_picks_and_ranks_as_the_reference(name):
    mine = planner.Planner(discriminant="flops", backend="torch",
                           device="cpu")
    theirs = ref_planner.Planner(discriminant="flops", backend="numpy")
    for point in _points(name):
        chain = get_spec(name).chain(point)
        got = mine.plan(chain)
        want = theirs.plan(ref_get_spec(name).chain(point))
        assert got.algorithm.name == want.algorithm.name, point
        assert got.ranked == want.ranked, point
        assert got.discriminant == "flops" and got.flops == want.flops
        assert mine.plan(chain) is got                 # memoised


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_plan_fn_equals_the_reference_plan_fn(name, backend):
    """``Plan.fn`` on the port's CPU backend (``cuda``: the kernels' plain
    versions) against the reference's on ``numpy``, same operands."""
    mine = planner.Planner(discriminant="flops", backend=backend,
                           device="cpu")
    theirs = ref_planner.Planner(discriminant="flops", backend="numpy")
    ref_runner = ref_get_backend("numpy", seed=0)
    for point in _points(name):
        got_plan = mine.plan(get_spec(name).chain(point))
        want_plan = theirs.plan(ref_get_spec(name).chain(point))
        operands = ref_runner.make_operands(want_plan.algorithm)
        args = [operands.get(b) for b in range(max(operands) + 1)]
        want = np.asarray(want_plan.fn(*args))
        got = got_plan.fn(*[None if a is None else
                            torch.from_numpy(np.asarray(a, np.float32))
                            for a in args])
        np.testing.assert_allclose(got.numpy(), want, err_msg=str(point),
                                   **TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_perfmodel_under_a_shared_table_picks_as_the_reference(name):
    for i, point in enumerate(_points(name)):
        table, ref_table = _tables(name, point, seed=i)
        got = planner.Planner(discriminant="perfmodel", profile=table,
                              backend="torch", device="cpu").plan(
            get_spec(name).chain(point))
        want = ref_planner.Planner(discriminant="perfmodel",
                                   profile=ref_table, backend="numpy").plan(
            ref_get_spec(name).chain(point))
        assert got.algorithm.name == want.algorithm.name, point
        assert got.ranked == want.ranked, point


@pytest.mark.parametrize("name", ["aatb", "abcd", "abab", "decmlp"])
def test_observe_apportions_as_the_reference(name):
    """One measured execution folded into the same explicit table: the
    same shares, blended the same way, in both packages."""
    point = _points(name)[0]
    table, ref_table = _tables(name, point, seed=7)
    mine = planner.Planner(discriminant="perfmodel", profile=table,
                           backend="torch", device="cpu", record=True)
    theirs = ref_planner.Planner(discriminant="perfmodel", profile=ref_table,
                                 backend="numpy", record=True)
    plan = mine.plan(get_spec(name).chain(point))
    ref_plan = theirs.plan(ref_get_spec(name).chain(point))
    assert plan.algorithm.name == ref_plan.algorithm.name
    gen = table.generation
    for seconds in (1e-3, 4e-4, 2e-3):
        mine.observe(plan, seconds)
        theirs.observe(ref_plan, seconds)
    assert table.generation > gen
    assert table.table.keys() == ref_table.table.keys()
    for key, t in ref_table.table.items():
        assert table.table[key] == pytest.approx(t, rel=1e-12), key
    mine.observe(plan, 0.0)                       # ignored, as there
    assert table.table.keys() == ref_table.table.keys()


def test_observe_weighs_by_the_hopper_model_where_the_table_lacks_a_kind():
    """The reference falls back to its TPU model here; the port weighs a
    plain table's unknown kinds by ``AnalyticalHopperProfile``."""
    table = TableProfile(peak_flops=1e12)
    mine = planner.Planner(discriminant="perfmodel", profile=table,
                           backend="torch", device="cpu", record=True)
    # (a bare table lacking a kind cannot rank: plan with another policy)
    plan = planner.Planner(discriminant="flops", device="cpu").plan(
        get_spec("abcd").chain((40, 50, 60, 70, 80)))
    calls = plan.algorithm.calls
    mine.observe(plan, 1e-3)
    hopper = AnalyticalHopperProfile()
    preds = [hopper.time(c, 4) for c in calls]
    for call, pred in zip(calls, preds):
        assert table.table[(call.kind, call.dims)] == pytest.approx(
            1e-3 * pred / sum(preds))


def test_profiles_resolve_in_three_tiers():
    explicit = TableProfile(peak_flops=1.0)
    assert planner.resolve_profile(explicit, device="cpu") is explicit
    assert isinstance(planner.resolve_profile(device="cpu"),
                      AnalyticalHopperProfile)
    fp = current_fingerprint(backend="cuda", dtype="float32", device="cpu")
    save_profile(TableProfile(peak_flops=1e12, table={
        ("gemm", (8, 8, 8)): 1e-5}), fp)
    cached = planner.resolve_profile(device="cpu")
    assert isinstance(cached, HybridProfile)
    assert cached.table_profile.table == {("gemm", (8, 8, 8)): 1e-5}
    assert isinstance(cached.analytical, AnalyticalHopperProfile)
    # A default planner on the CPU reads the same cache.
    p = planner.Planner(device="cpu")
    assert isinstance(p.profile, HybridProfile)
    assert (p.profile_backend, p.profile_dtype) == ("cuda", "float32")


def test_recording_planner_times_folds_and_saves(tmp_path):
    p = planner.Planner(discriminant="perfmodel", backend="cuda",
                        device="cpu", record=True, profile=as_hybrid(None))
    chain = get_spec("decmlp").chain((2, 32, 64))
    runner = TorchBackend(device="cpu", seed=0)
    plan = p.plan(chain)
    operands = runner.make_operands(plan.algorithm)
    args = [operands.get(b) for b in range(max(operands) + 1)]
    gen = p.profile_generation()
    out = p(chain, *args)
    torch.testing.assert_close(out, (args[0] @ args[1]) @ args[2],
                               rtol=1e-4, atol=1e-3)
    assert p.profile_generation() > gen
    assert set(p.profile.table_profile.table) == {
        (c.kind, c.dims) for c in plan.algorithm.calls}
    path = p.save(tmp_path)
    assert path.name == "profile-cuda-cpu-float32.json"
    # A pure-arithmetic policy never re-ranks on refinement.
    assert planner.Planner(discriminant="flops",
                           device="cpu").profile_generation() == -1


def test_planner_rejects_unknown_discriminants_and_defaults_to_the_card():
    with pytest.raises(ValueError, match="nope"):
        planner.Planner(discriminant="nope", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            planner.default_planner()


def test_module_level_plan_memoises_per_discriminant(monkeypatch):
    class CpuPlanner(planner.Planner):
        def __init__(self, discriminant="perfmodel", **kw):
            super().__init__(discriminant=discriminant, device="cpu", **kw)

    monkeypatch.setattr(planner, "Planner", CpuPlanner)
    chain = get_spec("abcd").chain((8, 64, 8, 64, 8))
    first = planner.plan(chain, discriminant="flops")
    assert planner.plan(chain, discriminant="flops") is first
    assert planner.plan(chain).discriminant == "perfmodel"
    assert planner.default_planner() is planner.default_planner()


def test_hopper_model_ranks_calls_the_planner_dispatches():
    """Every call of every decode family plan is priced by the Hopper
    model (no unknown kind)."""
    hopper = AnalyticalHopperProfile()
    p = planner.Planner(device="cpu")
    for family, dims in (("decattn", (1, 2064, 128, 4096)),
                         ("decproj", (1, 4096, 64000)),
                         ("decmlp", (1, 4096, 11008))):
        plan = p.plan(get_spec(family).chain(dims))
        assert all(hopper.time(KernelCall(c.kind, c.dims)) > 0
                   for c in plan.algorithm.calls)
        assert plan.algorithm.name.startswith("alg1")   # left first
