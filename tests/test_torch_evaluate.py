"""The port's discriminants, evaluation, predicted sweeps and the paper's
three experiments against the JAX package's.

On one atlas swept by the port on the CPU, and one profile, every
discriminant's scoreboard row — top-1, mean and p95 regret, confusion
matrix — equals the reference's exactly. Line scans, Experiment 1's
sample sequence and Experiment 3's confusion matrix equal the
reference's on a deterministic stand-in for a backend. The registry and
scoreboard tests of ``tests/test_discriminants.py`` are mirrored where
they apply, and the sweep CLI's predict and evaluate modes run on the
CPU.
"""

import os
import pathlib
import re
import subprocess
import sys
import warnings
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import anomaly as ref_anomaly
from repro.core import evaluate as ref_evaluate
from repro.core import experiments as ref_experiments
from repro.core import perfmodel as ref_perfmodel
from repro.core import sweep as ref_sweep
from repro.core.expressions import get_spec as ref_get_spec
from repro_torch.core import anomaly, evaluate, experiments
from repro_torch.core import sweep as sweep_mod
from repro_torch.core.anomaly import classify, pick_regret
from repro_torch.core.backends import CudaBackend
from repro_torch.core.discriminants import (
    _REGISTRY,
    Discriminant,
    DiscriminantContext,
    RankKDiscriminant,
    RooflineDiscriminant,
    get_discriminant,
    register_discriminant,
    registered_discriminants,
    shared_runner,
    validate_arguments,
)
from repro_torch.core.expressions import GRAM_AATB, find_spec, get_spec
from repro_torch.core.flops import gemm, tri2full
from repro_torch.core.perfmodel import (H100_SXM, AnalyticalHopperProfile,
                                        AnalyticalTPUProfile, HybridProfile,
                                        RooflineProfile, TableProfile)
from repro_torch.core.selector import rank_by_measurement, select
from repro_torch.core.sweep import Instance

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = pathlib.Path(__file__).parent / "fixtures"
SIX = ("flops", "perfmodel", "hybrid", "roofline", "measured", "rankk")
POINT = (16, 8, 12)


def _algos():
    return GRAM_AATB.algorithms(POINT)


def _call_seconds(call) -> float:
    """Deterministic per-call seconds: kind-dependent rates (syrk and symm
    slower per flop than gemm, tri2full paying for traffic) plus a fixed
    cost and a shape hash, so FLOP-cheap algorithms can lose."""
    rate = {"gemm": 1.0e-11, "syrk": 2.6e-11, "symm": 1.9e-11,
            "tri2full": 0.0}[call.kind]
    jitter = zlib.crc32(f"{call.kind}{call.dims}".encode()) % 997 * 1e-9
    return rate * call.flops + 4e-10 * call.bytes_moved + 2e-6 + jitter


class _StubRunner:
    """A deterministic stand-in for an execution backend that either
    package's sweep, experiments and discriminants accept: times are pure
    functions of the algorithm's calls, with a per-algorithm factor the
    additive model cannot see. Records what it timed, in order."""

    def __init__(self):
        self.benched = []
        self.timed = []

    def make_operands(self, alg):
        return {ref.base: None for step in alg.steps
                for ref in (step.lhs, step.rhs)
                if getattr(ref, "base", None) is not None}

    def time_algorithm(self, alg, operands=None, reps=None):
        dims = tuple(c.dims for c in alg.calls)
        self.timed.append((alg.name, dims))
        factor = 0.7 + zlib.crc32(f"{alg.name}{dims}".encode()) % 600 / 1000
        return factor * sum(_call_seconds(c) for c in alg.calls)

    def benchmark_call(self, call, reps=None):
        self.benched.append((call.kind, call.dims))
        return _call_seconds(call)


class _NoTiming(_StubRunner):
    def benchmark_call(self, call, reps=None):
        raise AssertionError(f"timed {call} though the profile covers it")


# ------------------------------------------------------------- registry ----


def test_registry_ships_six_policies():
    assert registered_discriminants() == sorted(SIX)


def test_capability_flags_match_the_reference():
    from repro.core.discriminants import get_discriminant as ref_get

    for name in SIX:
        mine, theirs = get_discriminant(name), ref_get(name)
        assert (mine.requires_profile, mine.requires_measurement,
                mine.fingerprint()) == (theirs.requires_profile,
                                        theirs.requires_measurement,
                                        theirs.fingerprint())


def test_get_unknown_discriminant_lists_registry():
    with pytest.raises(KeyError, match="registered"):
        get_discriminant("nope")


def test_duplicate_registration_rejected():
    with pytest.raises(ValueError, match="already registered"):
        register_discriminant(RankKDiscriminant(), name="flops")


def test_register_custom_discriminant_recipe():
    class Antimodel(Discriminant):
        name = "antimodel"

        def predict_times(self, algos, ctx):
            return {a.name: -float(a.flops) for a in algos}

    register_discriminant(Antimodel())
    try:
        ranked = select(_algos(), "antimodel")
        assert ranked[0].flops == max(a.flops for a in _algos())
        assert ranked[-1].flops == min(a.flops for a in _algos())
        assert "antimodel" in registered_discriminants()
    finally:
        _REGISTRY.pop("antimodel")


def test_discriminants_tuple_deprecated():
    import repro_torch.core.selector as selector

    with pytest.warns(DeprecationWarning, match="registered_discriminants"):
        legacy = selector.DISCRIMINANTS
    assert set(legacy) == set(registered_discriminants())
    with pytest.raises(AttributeError):
        selector.NOT_A_NAME
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        exec("from repro_torch.core.selector import *", {})


def test_port_defaults_are_the_h100s():
    """float32 elements, the Hopper launch model, the H100's roofline
    and the cuda backend."""
    ctx = DiscriminantContext()
    assert ctx.dtype_bytes == 4
    assert isinstance(get_discriminant("perfmodel")._profile(ctx),
                      AnalyticalHopperProfile)
    assert isinstance(get_discriminant("hybrid")._profile(ctx).analytical,
                      AnalyticalHopperProfile)
    assert get_discriminant("roofline")._roofline.hw == H100_SXM
    hopper = AnalyticalHopperProfile()
    times = get_discriminant("perfmodel").predict_times(_algos(), ctx)
    assert times == {a.name: sum(hopper.time(c, 4) for c in a.calls)
                     for a in _algos()}


def test_shared_default_runner_is_the_card():
    if torch.cuda.is_available():
        assert shared_runner("cuda") is shared_runner("cuda")
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shared_runner("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_by_measurement(_algos())


# ------------------------------------------- capability-flag validation ----


@pytest.mark.parametrize("disc", ["flops", "measured", "roofline"])
def test_select_rejects_profile_for_profile_free_policies(disc):
    with pytest.raises(ValueError, match="requires_profile"):
        select(_algos(), disc, profile=TableProfile(1e11))


@pytest.mark.parametrize("disc", ["flops", "perfmodel", "hybrid",
                                  "roofline"])
def test_select_rejects_runner_for_measurement_free_policies(disc):
    with pytest.raises(ValueError, match="requires_measurement"):
        select(_algos(), disc, backend="torch")
    with pytest.raises(ValueError, match="requires_measurement"):
        select(_algos(), disc, runner=_StubRunner())


def test_select_rejects_runner_and_backend_together():
    with pytest.raises(ValueError, match="not both"):
        select(_algos(), "measured", runner=_StubRunner(), backend="torch")
    with pytest.raises(ValueError, match="not both"):
        validate_arguments(get_discriminant("measured"),
                           runner=_StubRunner(), backend="torch")
    with pytest.raises(ValueError, match="not both"):
        rank_by_measurement(_algos(), runner=_StubRunner(), backend="torch")


def test_select_unknown_discriminant_is_value_error():
    with pytest.raises(ValueError, match="unknown discriminant"):
        select(_algos(), "nope")


# ------------------------------------------------ measurement + rankk ------


def test_rank_by_measurement_dedups_shared_calls():
    runner = _StubRunner()
    ranked = rank_by_measurement(_algos(), runner=runner)
    assert {a.name for a in ranked} == {a.name for a in _algos()}
    assert len(runner.benched) == len(set(runner.benched))
    assert len(runner.benched) < sum(len(a.calls) for a in _algos())


def test_rank_by_measurement_on_the_cpu_backend():
    ranked = rank_by_measurement(
        _algos(), runner=CudaBackend(device="cpu", reps=1, seed=0))
    assert sorted(a.name for a in ranked) == sorted(a.name for a in _algos())


def test_rankk_times_only_top_k_flops_candidates():
    runner = _StubRunner()
    k = 2
    ranked = RankKDiscriminant(k=k).rank(_algos(),
                                         DiscriminantContext(runner=runner))
    assert {a.name for a in ranked} == {a.name for a in _algos()}
    top = sorted(_algos(), key=lambda a: (a.flops, a.name))[:k]
    assert set(runner.benched) == {(c.kind, c.dims) for a in top
                                   for c in a.calls}


def test_rankk_fingerprint_carries_budget():
    assert RankKDiscriminant(k=5).fingerprint() == "rankk(k=5)"
    with pytest.raises(ValueError, match="k >= 1"):
        RankKDiscriminant(k=0)


def test_roofline_charges_traffic_flops_cannot_see():
    assert RooflineProfile(H100_SXM).time(tri2full(512), dtype_bytes=4) == \
        512 * 512 * 4 / H100_SXM.hbm_bw
    assert [a.name for a in select(_algos(), "roofline")] == \
        [a.name for a in select(_algos(), "roofline")]


# ------------------------------------------------- classify edge cases -----


def test_classify_edge_cases_match_the_reference():
    cases = [
        ({"a": 1.0, "b": 1.0, "c": 1.0}, {"a": 10, "b": 20, "c": 30}, 0.0),
        ({"a": 1.0, "b": 1.0 + 5e-10, "c": 1.1}, {"a": 2, "b": 1, "c": 1},
         0.10),
        ({"a": 0.0, "b": 0.0}, {"a": 5, "b": 1}, 0.10),
        ({"a": 2.0, "b": 1.0}, {"a": 0, "b": 0}, 0.0),
        ({"cheap": 1.0, "fast": 0.875}, {"cheap": 1, "fast": 2}, 0.125),
        ({"cheap": 1.0, "fast": 0.875}, {"cheap": 1, "fast": 2}, 0.124),
    ]
    for times, flops, threshold in cases:
        mine = classify(times, flops, threshold=threshold)
        theirs = ref_anomaly.classify(times, flops, threshold=threshold)
        assert (mine.is_anomaly, mine.time_score, mine.flop_score,
                mine.cheapest, mine.fastest) == (
            theirs.is_anomaly, theirs.time_score, theirs.flop_score,
            theirs.cheapest, theirs.fastest)
    at = classify({"cheap": 1.0, "fast": 0.875}, {"cheap": 1, "fast": 2},
                  threshold=0.125)
    assert at.time_score == 0.125 and not at.is_anomaly


def test_pick_regret():
    times = {"a": 2.0, "b": 1.0}
    assert pick_regret(times, "a") == 1.0
    assert pick_regret(times, "b") == 0.0
    assert pick_regret({"a": 0.0, "b": 0.0}, "a") == 0.0


def test_confusion_matrix_matches_the_reference():
    mine, theirs = anomaly.ConfusionMatrix(), ref_anomaly.ConfusionMatrix()
    for actual, predicted in [(1, 1), (1, 0), (0, 1), (0, 0), (1, 1)]:
        mine.add(bool(actual), bool(predicted))
        theirs.add(bool(actual), bool(predicted))
    assert mine.as_table() == theirs.as_table()
    assert (mine.recall, mine.precision, mine.total) == (
        theirs.recall, theirs.precision, theirs.total) == (2 / 3, 2 / 3, 5)


# -------------------------------------------------------------- line scans --


def _classifier(origin_dim_box):
    """Anomalous inside a box with a two-probe hole; severity varies."""
    lo, hi = origin_dim_box

    def classify_at(point):
        inside = all(lo <= x <= hi for x in point)
        hole = 150 <= point[0] < 170
        anom = inside and not hole
        ts = (sum(point) % 17) / 100
        return anomaly.Classification(anom, ts, ts / 2, ("a",), ("b",))

    return classify_at


@pytest.mark.parametrize("origin,dim,step", [
    ((100, 200, 300), 0, 10), ((100, 200, 300), 1, 10),
    ((400, 40, 90), 2, 40), ((60, 60, 60), 0, 25)])
def test_scan_line_matches_the_reference(origin, dim, step):
    classify_at = _classifier((50, 500))
    mine = anomaly.scan_line(classify_at, origin, dim, 20, 1200, step=step)
    theirs = ref_anomaly.scan_line(classify_at, origin, dim, 20, 1200,
                                   step=step)
    assert (mine.dim, mine.origin, mine.points, mine.lo, mine.hi,
            mine.thickness) == (theirs.dim, theirs.origin, theirs.points,
                                theirs.lo, theirs.hi, theirs.thickness)
    assert mine.lo >= 50 - step and mine.hi <= 500 + step


# -------------------------------------------------------------- evaluation --


def _records(seed: int, points=((16, 8, 12), (24, 12, 8))):
    """Synthetic fully measured records with random (positive) times."""
    rng = np.random.default_rng(seed)
    out = []
    for p in points:
        algos = GRAM_AATB.algorithms(p)
        times = {a.name: float(t) for a, t in
                 zip(algos, rng.uniform(1e-4, 1e-2, len(algos)))}
        flops = {a.name: a.flops for a in algos}
        out.append(Instance(tuple(p), times, flops,
                            classify(times, flops, threshold=0.10)))
    return out


def test_evaluate_scores_every_requested_policy():
    records = _records(0)
    res = evaluate.evaluate_discriminants(
        GRAM_AATB, records, ["flops", "perfmodel", "measured"])
    assert set(res.scores) == {"flops", "perfmodel", "measured"}
    assert res.n_instances == len(records)
    for s in res.scores.values():
        assert 0.0 <= s.top1_accuracy <= 1.0
        assert all(r >= 0 for r in s.regrets)
        assert s.p95_regret >= 0.0
    assert "top1=" in res.summary()


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10 ** 6))
def test_measured_has_zero_regret_on_its_own_atlas(seed):
    s = evaluate.evaluate_discriminants(
        GRAM_AATB, _records(seed), ["measured"]).scores["measured"]
    assert s.top1_accuracy == 1.0
    assert s.mean_regret == 0.0 and s.p95_regret == 0.0
    assert s.confusion.fp == 0 and s.confusion.fn == 0


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10 ** 6))
def test_flops_never_predicts_an_anomaly(seed):
    res = evaluate.evaluate_discriminants(GRAM_AATB, _records(seed),
                                          ["flops"])
    cm = res.scores["flops"].confusion
    assert cm.tp == 0 and cm.fp == 0
    if res.n_anomalies:
        assert res.scores["flops"].recall == 0.0


def test_evaluate_rejects_records_of_other_enumerations():
    rec = _records(1)[0]
    rec.times.pop(sorted(rec.times)[0])
    with pytest.raises(ValueError, match="lacks times"):
        evaluate.evaluate_discriminants(GRAM_AATB, [rec], ["flops"])
    rec = _records(1)[0]
    rec.times["alg99[future]"] = 1e-3
    with pytest.raises(ValueError, match="unknown.*different enumeration"):
        evaluate.evaluate_discriminants(GRAM_AATB, [rec], ["flops"])


def test_evaluate_isolates_per_policy_failures():
    prof = TableProfile(1e11)
    prof.record(gemm(8, 8, 8), 1e-6)   # gemm-only: no syrk/symm entries
    res = evaluate.evaluate_discriminants(
        GRAM_AATB, _records(4), ["perfmodel", "hybrid", "flops"],
        profile=prof)
    assert "KeyError" in res.scores["perfmodel"].error
    assert "failed:" in res.scores["perfmodel"].row()
    assert res.scores["hybrid"].error is None
    assert res.scores["flops"].error is None


def test_evaluate_scores_the_policy_rank_not_the_argsort():
    class Contrarian(Discriminant):
        name = "contrarian"

        def predict_times(self, algos, ctx):
            return {a.name: float(a.flops) for a in algos}

        def rank(self, algos, ctx):   # NOT the argsort of predict_times
            return sorted(algos, key=lambda a: (-a.flops, a.name))

    register_discriminant(Contrarian())
    try:
        records = _records(5)
        s = evaluate.evaluate_discriminants(
            GRAM_AATB, records, ["contrarian"]).scores["contrarian"]
        expected = []
        for inst in records:
            pick = sorted(GRAM_AATB.algorithms(inst.point),
                          key=lambda a: (-a.flops, a.name))[0]
            expected.append(pick_regret(inst.times, pick.name))
        assert s.regrets == tuple(expected)
    finally:
        _REGISTRY.pop("contrarian")


def test_evaluate_dedupes_repeated_discriminant_names():
    res = evaluate.evaluate_discriminants(GRAM_AATB, _records(3),
                                          ["measured", "measured"])
    assert list(res.scores) == ["measured"]
    assert res.scores["measured"].top1_accuracy == 1.0
    assert len(res.scores["measured"].regrets) == res.n_instances


def test_legacy_reference_atlas_normalizes_and_evaluates():
    replay = evaluate.load_atlas_records(FIXTURES / "legacy_atlas_aatb.jsonl")
    assert replay.legacy and replay.fingerprint.backend == "blas"
    assert replay.spec_name == "AATB" and len(replay.records) == 4
    assert replay.skipped_lines == 1
    assert find_spec(replay.spec_name) is GRAM_AATB
    res = evaluate.evaluate_atlas(replay, ["flops", "measured"])
    assert res.n_instances == 4
    assert res.scores["measured"].top1_accuracy == 1.0


# ------------------------------------- the scoreboard against the reference --

def _atlas(tmp_path, name):
    """A seeded CPU sweep of ``name``'s smoke grid on the cuda backend's
    plain versions (real, noisy times; both packages read the one file)."""
    spec = get_spec(name)
    runner = CudaBackend(device="cpu", reps=1, seed=0)
    fp = runner.fingerprint()
    path = sweep_mod.atlas_path(spec.name, fp, 0.10, tmp_path)
    sweep_mod.sweep(spec, spec.grid("smoke").points(), runner=runner,
                    atlas=sweep_mod.AnomalyAtlas(path, fp, spec.name, 0.10))
    return path


def _profiles(name, variant):
    """(port profile, reference profile) holding the same numbers."""
    spec = get_spec(name)
    calls = sweep_mod.collect_unique_calls(spec, spec.grid("smoke").points())
    table = {(c.kind, c.dims): _call_seconds(c) for c in calls}
    if variant == "table":       # covers every call
        return (TableProfile(1e11, table),
                ref_perfmodel.TableProfile(1e11, table))
    if variant == "partial":     # gemm only, TPU fallback for the rest
        part = {k: t for k, t in table.items() if k[0] == "gemm"}
        return (HybridProfile(TableProfile(1e11, part),
                              analytical=AnalyticalTPUProfile()),
                ref_perfmodel.HybridProfile(
                    ref_perfmodel.TableProfile(1e11, part),
                    analytical=ref_perfmodel.AnalyticalTPUProfile()))
    return AnalyticalTPUProfile(), ref_perfmodel.AnalyticalTPUProfile()


def _row(score):
    cm = score.confusion
    return (score.n_instances, score.top1_hits, score.regrets,
            score.mean_regret, score.p95_regret, score.error,
            None if cm is None else (cm.tp, cm.fp, cm.fn, cm.tn))


@pytest.mark.parametrize("variant", ["table", "partial", "analytical"])
@pytest.mark.parametrize("name", ["aatb", "abcd", "abab"])
def test_scoreboard_equals_the_references(tmp_path, monkeypatch, name,
                                          variant):
    """All six policies, one atlas, one profile: identical rows. The
    port's roofline ranks with the H100's constants; for the comparison
    it is handed the reference's."""
    monkeypatch.setitem(_REGISTRY, "roofline", RooflineDiscriminant(
        RooflineProfile(AnalyticalTPUProfile().hw)))
    path = _atlas(tmp_path, name)
    mine_prof, ref_prof = _profiles(name, variant)
    for threshold in (0.10, 0.05):
        mine = evaluate.evaluate_atlas(path, SIX, profile=mine_prof,
                                       threshold=threshold, dtype_bytes=4)
        theirs = ref_evaluate.evaluate_atlas(path, SIX, profile=ref_prof,
                                             threshold=threshold,
                                             dtype_bytes=4)
        assert (mine.n_instances, mine.n_anomalies) == (
            theirs.n_instances, theirs.n_anomalies)
        assert mine.n_instances == get_spec(name).grid("smoke").n_points
        for policy in SIX:
            assert _row(mine.scores[policy]) == _row(theirs.scores[policy])
        assert mine.summary() == theirs.summary()


def test_the_port_atlas_header_is_read_for_replay(tmp_path):
    path = _atlas(tmp_path, "abab")
    replay = evaluate.load_atlas_records(path)
    assert not replay.legacy and replay.skipped_lines == 0
    assert replay.fingerprint.device == "cpu" and replay.threshold == 0.10
    assert len(replay.records) == 8
    atlas = sweep_mod.AnomalyAtlas(path, replay.fingerprint,
                                   replay.spec_name, 0.10)
    assert _row(evaluate.evaluate_atlas(atlas, ["measured"]).scores[
        "measured"]) == _row(evaluate.evaluate_atlas(replay, ["measured"])
                             .scores["measured"])


def test_predicted_classifications_match_the_reference():
    spec, ref_spec = get_spec("aatb"), ref_get_spec("aatb")
    points = spec.grid("smoke").points()
    mine_prof, ref_prof = _profiles("aatb", "table")
    mine = sweep_mod.predict_classifications(spec, points, mine_prof,
                                             threshold=0.05)
    theirs = ref_sweep.predict_classifications(ref_spec, points, ref_prof,
                                               threshold=0.05, dtype_bytes=4)
    assert {p: (c.is_anomaly, c.time_score, c.fastest)
            for p, c in mine.items()} == {
        p: (c.is_anomaly, c.time_score, c.fastest)
        for p, c in theirs.items()}
    grid = spec.grid("smoke")
    assert [r.points for r in sweep_mod.cluster_predictions(mine, grid)] == \
        [r.points for r in ref_sweep.cluster_predictions(
            theirs, ref_spec.grid("smoke"))]


def test_benchmark_unique_calls_reuses_the_profile():
    spec = get_spec("aatb")
    calls = sweep_mod.collect_unique_calls(spec, spec.grid("smoke").points())
    assert [(c.kind, c.dims) for c in calls] == [
        (c.kind, c.dims) for c in ref_sweep.collect_unique_calls(
            ref_get_spec("aatb"), spec.grid("smoke").points())]
    runner = _StubRunner()
    prof, n_meas, n_reused = sweep_mod.benchmark_unique_calls(
        runner, calls + calls[:3])
    assert (n_meas, n_reused) == (len(calls), 0)
    assert prof.peak() == max(c.flops / _call_seconds(c) for c in calls
                              if c.flops)
    again, n_meas, n_reused = sweep_mod.benchmark_unique_calls(
        _NoTiming(), calls, profile=prof)
    assert again is prof and (n_meas, n_reused) == (0, len(calls))


# ------------------------------------------------------------ experiments --


def test_experiment1_visits_the_references_samples(monkeypatch):
    monkeypatch.setenv(ref_sweep.FASTPATH_ENV, "1")   # request order
    mine_r, ref_r = _StubRunner(), _StubRunner()
    kw = dict(box=(20, 300), n_anomalies=4, max_samples=60, seed=3,
              batch=7)
    mine = experiments.experiment1_random_search(get_spec("aatb"), mine_r,
                                                 **kw)
    theirs = ref_experiments.experiment1_random_search(
        ref_get_spec("aatb"), ref_r, **kw)
    assert mine_r.timed == ref_r.timed and mine_r.timed
    assert mine.samples == theirs.samples
    assert [a.point for a in mine.anomalies] == \
        [a.point for a in theirs.anomalies]
    assert len(mine.anomalies) >= 4 or mine.samples == 60
    # The reference's guard: a runner configures only the serial engine.
    for engine in ("process", "devices"):
        with pytest.raises(ValueError, match="only configures the serial"):
            experiments.experiment1_random_search(get_spec("aatb"), mine_r,
                                                  backend=engine)
    with pytest.raises(ValueError, match="only configures the serial"):
        ref_experiments.experiment1_random_search(ref_get_spec("aatb"),
                                                  ref_r, backend="process")


def test_experiment2_scans_as_the_reference():
    spec, ref_spec = get_spec("aatb"), ref_get_spec("aatb")
    seeds = experiments.experiment1_random_search(
        spec, _StubRunner(), box=(20, 300), n_anomalies=2, max_samples=50,
        seed=1).anomalies[:2]
    assert seeds
    mine = experiments.experiment2_regions(spec, _StubRunner(), seeds,
                                           box=(20, 300), step=20)
    theirs = ref_experiments.experiment2_regions(ref_spec, _StubRunner(),
                                                 seeds, box=(20, 300),
                                                 step=20)
    assert len(mine.scans) == spec.ndims * len(seeds)
    assert [(s.dim, s.origin, s.points, s.lo, s.hi) for s in mine.scans] == \
        [(s.dim, s.origin, s.points, s.lo, s.hi) for s in theirs.scans]
    assert mine.classified.keys() == theirs.classified.keys()


def test_experiment3_on_a_covering_profile_times_nothing():
    spec, ref_spec = get_spec("aatb"), ref_get_spec("aatb")
    runner = _StubRunner()
    classified = {r.point: r for r in sweep_mod.sweep(
        spec, spec.grid("smoke").points(), runner=runner).records}
    ref_classified = {r.point: r for r in ref_sweep.sweep(
        ref_spec, spec.grid("smoke").points(), runner=_StubRunner(),
        fastpath=False).records}
    assert {p: r.times for p, r in classified.items()} == \
        {p: r.times for p, r in ref_classified.items()}
    mine_prof, ref_prof = _profiles("aatb", "table")
    mine = experiments.experiment3_predict_from_benchmarks(
        spec, _NoTiming(), classified, profile=mine_prof)
    theirs = ref_experiments.experiment3_predict_from_benchmarks(
        ref_spec, _NoTiming(), ref_classified, profile=ref_prof)
    cm, rcm = mine.confusion, theirs.confusion
    assert (cm.tp, cm.fp, cm.fn, cm.tn) == (rcm.tp, rcm.fp, rcm.fn, rcm.tn)
    assert (mine.n_calls_measured, mine.n_calls_reused) == (
        theirs.n_calls_measured, theirs.n_calls_reused) == (0, 18)
    # from an empty profile, each unique call is timed once
    fresh = experiments.experiment3_predict_from_benchmarks(
        spec, runner, classified)
    assert fresh.n_calls_measured == len(set(runner.benched)) == 18


def test_experiments_never_assume_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the defaults rightly use it")
    spec = get_spec("aatb")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        experiments.experiment1_random_search(spec, max_samples=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        experiments.experiment2_regions(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        experiments.experiment3_predict_from_benchmarks(spec, "cuda", {})
    res = experiments.experiment1_random_search(
        spec, "torch", box=(4, 12), n_anomalies=1, max_samples=3,
        device="cpu")
    assert res.samples == 3 or res.anomalies


# -------------------------------------------------------------------- CLI --


def _main(*args):
    return sweep_mod.main(["--backend", "cuda", "--device", "cpu",
                           "--quiet", *args])


def test_cli_mode_evaluate_prints_scoreboard(tmp_path, capsys):
    assert _main("--expr", "aatb", "--grid", "8,16", "--reps", "1",
                 "--atlas-dir", str(tmp_path)) == 0
    capsys.readouterr()
    assert _main("--expr", "aatb", "--grid", "8,16", "--mode", "evaluate",
                 "--atlas-dir", str(tmp_path), "--discriminants",
                 "flops,perfmodel,hybrid") == 0
    out = capsys.readouterr().out
    assert "evaluate AATB" in out and "profile=analytical" in out
    for name in ("flops", "perfmodel", "hybrid"):
        assert f"  {name} " in out
    assert "top1=" in out and "mean_regret=" in out
    assert "measured" not in out


def test_cli_mode_evaluate_survives_partial_calibration(tmp_path, capsys,
                                                        monkeypatch):
    from repro_torch.core.profile_store import (current_fingerprint,
                                                save_profile)

    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path / "profiles"))
    assert _main("--expr", "aatb", "--grid", "8,16", "--reps", "1",
                 "--atlas-dir", str(tmp_path)) == 0
    prof = TableProfile(1e11)
    prof.record(gemm(8, 8, 8), 1e-6)
    save_profile(prof, current_fingerprint(device="cpu"))
    capsys.readouterr()
    assert _main("--expr", "aatb", "--grid", "8,16", "--mode", "evaluate",
                 "--atlas-dir", str(tmp_path), "--discriminants",
                 "perfmodel,hybrid,flops") == 0
    out = capsys.readouterr().out
    assert "perfmodel  failed: KeyError" in out
    assert "hybrid" in out and "flops" in out and "top1=" in out
    assert "profile=cached" in out


def test_cli_mode_evaluate_rejections(tmp_path, capsys):
    assert _main("--expr", "aatb", "--grid", "8,16", "--mode", "evaluate",
                 "--atlas-dir", str(tmp_path)) == 2
    assert "sweep ground truth first" in capsys.readouterr().err
    assert _main("--expr", "aatb", "--grid", "8,16", "--reps", "1",
                 "--atlas-dir", str(tmp_path)) == 0
    assert _main("--expr", "aatb", "--grid", "8,16", "--mode", "evaluate",
                 "--atlas-dir", str(tmp_path), "--discriminants",
                 "flops,nope") == 2
    with pytest.raises(SystemExit):
        _main("--expr", "aatb", "--grid", "8,16", "--atlas-dir",
              str(tmp_path), "--discriminants", "flops")


def test_cli_mode_evaluate_reads_a_legacy_reference_atlas(tmp_path, capsys):
    import shutil

    shutil.copy(FIXTURES / "legacy_atlas_aatb.jsonl",
                tmp_path / "atlas-aatb-t0p1-legacy.jsonl")
    assert _main("--expr", "aatb", "--grid", "8,16", "--mode", "evaluate",
                 "--atlas-dir", str(tmp_path), "--discriminants",
                 "flops,measured") == 0
    out = capsys.readouterr().out
    assert "legacy-fingerprint" in out and "top1=" in out


def test_cli_predict_then_evaluate_end_to_end(tmp_path):
    """The whole CLI on the CPU: measure, predict twice (the second from
    the profile cache), evaluate all six discriminants."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_PROFILE_DIR=str(tmp_path / "profiles"))
    env.pop("REPRO_NO_FUSION", None)
    base = [sys.executable, "-m", "repro_torch.core.sweep", "--expr", "abab",
            "--grid", "smoke", "--device", "cpu", "--reps", "1", "--seed",
            "0", "--atlas-dir", str(tmp_path), "--quiet"]

    def run(*extra):
        proc = subprocess.run(base + list(extra), env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout

    assert "measured=8" in run()
    first = run("--mode", "predict")
    m = re.search(r"unique_kernels=(\d+) measured=(\d+) reused=0", first)
    assert m and m.group(1) == m.group(2) != "0"
    assert "vs atlas ground truth (8 instances): recall=" in first
    second = run("--mode", "predict")
    assert f"unique_kernels={m.group(1)} measured=0 reused={m.group(1)}" \
        in second
    assert list((tmp_path / "profiles").glob("*.json"))[0].name == \
        "profile-cuda-cpu-float32.json"
    out = run("--mode", "evaluate", "--discriminants", ",".join(SIX))
    assert "evaluate ABAB/smoke [cuda]: instances=8" in out
    assert "profile=cached" in out
    for name in SIX:
        assert re.search(rf"^  {name} +top1=", out, re.MULTILINE), out
    assert re.search(r"measured +top1=1\.000 mean_regret=0\.0% "
                     r"p95_regret=0\.0%", out)
    helped = subprocess.run(base[:3] + ["--help"], env=env,
                            capture_output=True, text=True, timeout=120)
    assert "registered discriminants (repro_torch.core.discriminants)" in \
        helped.stdout
    assert all(f"  {name} " in helped.stdout for name in SIX)


def test_cli_predict_needs_the_card_or_the_cpu_named(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the defaults rightly use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_mod.main(["--expr", "aatb", "--grid", "smoke", "--mode",
                        "predict", "--atlas-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_mod.main(["--expr", "aatb", "--grid", "smoke", "--mode",
                        "evaluate", "--atlas-dir", str(tmp_path)])

