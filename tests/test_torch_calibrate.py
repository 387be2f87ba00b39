"""The port's profiles, profile store and calibration against the JAX
package's.

Profiles answer with the reference's numbers on the same calls (no
tolerance: the same arithmetic on the same floats), a profile JSON
written by either package is read by the other with identical
predictions, calibration enumerates the reference's kernel calls, and
the Hopper analytical model charges each call what the kernel wrappers'
launch rules model. Also the store's failure modes, mirrored from
``tests/test_calibrate.py``.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.core import calibrate as ref_calibrate
from repro.core import perfmodel as ref_perfmodel
from repro.core import profile_store as ref_store
from repro.core.expressions import get_spec as ref_get_spec
from repro.core.flops import KernelCall as RefCall
from repro_torch.core import calibrate, perfmodel, profile_store
from repro_torch.core.backends import CudaBackend, TorchBackend
from repro_torch.core.discriminants import as_hybrid
from repro_torch.core.expressions import GridSpec, get_spec, registered_names
from repro_torch.core.flops import KernelCall, gemm, symm, syrk, tri2full
from repro_torch.core.perfmodel import (AnalyticalHopperProfile,
                                        AnalyticalTPUProfile, HybridProfile,
                                        RooflineProfile, TableProfile)
from repro_torch.core.sweep import collect_unique_calls
from repro_torch.core.profile_store import (FingerprintMismatchError,
                                            HardwareFingerprint,
                                            ProfileStoreError,
                                            SchemaVersionError,
                                            current_fingerprint,
                                            load_default_profile, load_profile,
                                            profile_path, save_profile)
from repro_torch.kernels import gemm as gemm_mod
from repro_torch.kernels import symm as symm_mod
from repro_torch.kernels import syrk as syrk_mod

ROOT = pathlib.Path(__file__).resolve().parents[1]
FP = HardwareFingerprint(backend="cuda", device="testdev", dtype="float32")


def _sample_table():
    return {
        ("gemm", (128, 128, 128)): 1.1e-4,
        ("gemm", (256, 64, 128)): 9.0e-5,
        ("syrk", (128, 128)): 7.5e-5,
        ("symm", (128, 64)): 6.0e-5,
        ("tri2full", (64,)): 1.0e-5,
        ("tri2full", (1024,)): 1.3e-3,
    }


def _sample_profile() -> TableProfile:
    return TableProfile(peak_flops=5e10, table=_sample_table())


QUERIES = [gemm(128, 128, 128), gemm(200, 100, 128), gemm(8192, 8192, 8192),
           syrk(96, 128), syrk(1200, 800), symm(130, 70), symm(1200, 400),
           tri2full(100), tri2full(1200)]


def _ref(call: KernelCall) -> RefCall:
    return RefCall(call.kind, call.dims)


def _calls(calls):
    return [(c.kind, c.dims, c.operands) for c in calls]


# ------------------------------------------------------- profile parity --

@pytest.mark.parametrize("call", QUERIES, ids=repr)
def test_profiles_answer_as_the_reference(call):
    pairs = [
        (TableProfile(5e10, _sample_table()),
         ref_perfmodel.TableProfile(5e10, _sample_table())),
        (AnalyticalTPUProfile(), ref_perfmodel.AnalyticalTPUProfile()),
        (RooflineProfile(), ref_perfmodel.RooflineProfile()),
        (HybridProfile(TableProfile(5e10, _sample_table()),
                       analytical=AnalyticalTPUProfile()),
         ref_perfmodel.HybridProfile(
             ref_perfmodel.TableProfile(5e10, _sample_table()))),
    ]
    for mine, theirs in pairs:
        for dtype_bytes in (2, 4, 8):
            assert mine.time(call, dtype_bytes) == \
                theirs.time(_ref(call), dtype_bytes)
    calls = [call, gemm(64, 64, 64)]
    assert perfmodel.predict_algorithm_time(calls, pairs[0][0], 4) == \
        ref_perfmodel.predict_algorithm_time(
            [_ref(c) for c in calls], pairs[0][1], 4)


# ------------------------------------------------------------ persistence --

def test_roundtrip_identical_predictions(tmp_path):
    prof = _sample_profile()
    path = save_profile(prof, FP, directory=tmp_path)
    loaded, fp = load_profile(path, expected_fingerprint=FP)
    assert fp == FP
    assert loaded.table == prof.table
    assert loaded.peak() == prof.peak()
    for call in QUERIES:
        assert loaded.time(call) == prof.time(call)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_profile_json_is_read_by_the_other_package(tmp_path, writer):
    """One schema: either package's file gives the other's TableProfile
    the writer's predictions, and both write the same document."""
    fp = dict(backend="cuda", device="NVIDIA H100 80GB HBM3",
              dtype="float32")
    mine = save_profile(_sample_profile(), HardwareFingerprint(**fp),
                        directory=tmp_path / "port", meta={"grid": "tiny"})
    theirs = ref_store.save_profile(
        ref_perfmodel.TableProfile(5e10, _sample_table()),
        ref_store.HardwareFingerprint(**fp), directory=tmp_path / "ref",
        meta={"grid": "tiny"})
    assert mine.name == theirs.name
    assert json.loads(mine.read_text()) == json.loads(theirs.read_text())
    if writer == "port":
        read, rfp = ref_store.load_profile(mine)
        assert rfp == ref_store.HardwareFingerprint(**fp)
        for call in QUERIES:
            assert read.time(_ref(call)) == _sample_profile().time(call)
    else:
        read, pfp = load_profile(theirs,
                                 expected_fingerprint=HardwareFingerprint(**fp))
        assert pfp == HardwareFingerprint(**fp)
        for call in QUERIES:
            assert read.time(call) == _sample_profile().time(call)


def test_fingerprint_mismatch_rejected(tmp_path):
    path = save_profile(_sample_profile(), FP, directory=tmp_path)
    other = HardwareFingerprint(backend="cuda", device="cpu", dtype="float32")
    with pytest.raises(FingerprintMismatchError):
        load_profile(path, expected_fingerprint=other)
    # without an expectation, the stored fingerprint is simply returned
    _, fp = load_profile(path)
    assert fp == FP


def test_schema_version_and_corruption_rejected(tmp_path):
    path = save_profile(_sample_profile(), FP, directory=tmp_path)
    doc = json.loads(path.read_text())
    doc["version"] = 999
    path.write_text(json.dumps(doc))
    with pytest.raises(SchemaVersionError, match="schema version 999"):
        load_profile(path)
    path.write_text("{not json")
    with pytest.raises(ProfileStoreError, match="unreadable"):
        load_profile(path)
    assert profile_store.SCHEMA_VERSION == ref_store.SCHEMA_VERSION == 1


def test_load_default_profile_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_NO_PROFILE_CACHE", raising=False)
    assert load_default_profile(device="cpu") is None  # empty cache
    fp = current_fingerprint(device="cpu")
    assert fp == HardwareFingerprint("cuda", "cpu", "float32")
    assert profile_path(fp) == tmp_path / "profile-cuda-cpu-float32.json"
    save_profile(_sample_profile(), fp)
    loaded = load_default_profile(device="cpu")
    assert loaded is not None and loaded.table == _sample_profile().table
    # another backend's or device's calibration is not this one
    assert load_default_profile(backend="torch", device="cpu") is None
    monkeypatch.setenv("REPRO_NO_PROFILE_CACHE", "1")
    assert load_default_profile(device="cpu") is None


def test_corrupt_default_cache_degrades_to_none(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path))
    fp = current_fingerprint(device="cpu")
    profile_path(fp).parent.mkdir(parents=True, exist_ok=True)
    profile_path(fp).write_text("garbage")
    assert load_default_profile(device="cpu") is None


def test_the_card_is_never_assumed():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the defaults rightly use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        current_fingerprint()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_default_profile()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate.calibrate(grid="tiny", save=False)


# ------------------------------------------------------------ calibration --

@pytest.mark.parametrize("grid", sorted(calibrate.GRIDS))
def test_grid_calls_match_reference(grid):
    assert calibrate.GRIDS == ref_calibrate.GRIDS
    mine = calibrate.grid_calls(calibrate.GRIDS[grid])
    assert _calls(mine) == _calls(
        ref_calibrate.grid_calls(ref_calibrate.GRIDS[grid]))
    n = len(calibrate.GRIDS[grid])
    assert len(mine) == n ** 3 + 2 * n ** 2 + n == len(set(mine))


@pytest.mark.parametrize("name", registered_names())
def test_expression_calls_match_reference(name):
    for grid in ("smoke", "small"):
        assert _calls(calibrate.expression_calls(get_spec(name), grid)) == \
            _calls(ref_calibrate.expression_calls(ref_get_spec(name), grid))
    # the port also takes a sweep's comma-separated axes
    spec = get_spec(name)
    assert calibrate.expression_calls(spec, "16,32") == \
        collect_unique_calls(spec, GridSpec.uniform((16, 32),
                                                    spec.ndims).points())


def test_sweep_kernels_times_every_call_once():
    runner = TorchBackend(device="cpu", reps=1, seed=0)
    calls = calibrate.grid_calls(calibrate.GRIDS["tiny"])
    seen = []
    prof = calibrate.sweep_kernels(
        runner, calibrate.GRIDS["tiny"], reps=1,
        progress=lambda i, n, call, s: seen.append((i, n, call)))
    assert [c for _, _, c in seen] == calls
    assert seen[-1][:2] == (len(calls), len(calls))
    assert set(prof.table) == {(c.kind, c.dims) for c in calls}
    assert all(t > 0 for t in prof.table.values())
    assert prof.peak() == max(c.flops / prof.table[(c.kind, c.dims)]
                              for c in calls if c.flops)
    with pytest.raises(ValueError, match="label 'float64'"):
        calibrate.sweep_kernels(runner, (8,), dtype="float64")


def test_calibrate_saves_and_family_runs_merge(tmp_path):
    res = calibrate.calibrate(backend="torch", grid="tiny", reps=1,
                              out=tmp_path, device="cpu", seed=0)
    assert res.fingerprint == HardwareFingerprint("torch", "cpu", "float32")
    assert res.path == tmp_path / "profile-torch-cpu-float32.json"
    assert res.n_calls == len(calibrate.grid_calls(calibrate.GRIDS["tiny"]))
    loaded, _ = load_profile(res.path, expected_fingerprint=res.fingerprint)
    assert loaded.table == res.profile.table
    doc = json.loads(res.path.read_text())
    assert doc["meta"]["grid"] == "tiny" and doc["meta"]["reps"] == 1
    # a family-targeted run adds its calls to the saved grid calibration
    fam = calibrate.calibrate(backend="cuda", expr="aatb", grid="8,16",
                              reps=1, out=tmp_path, device="cpu", seed=0)
    assert fam.path != res.path    # another backend, another file
    fam2 = calibrate.calibrate(backend="torch", expr="aatb", grid="8,16",
                               reps=1, out=tmp_path, device="cpu", seed=0)
    family = calibrate.expression_calls(get_spec("aatb"), "8,16")
    assert set(fam2.profile.table) == set(res.profile.table) | {
        (c.kind, c.dims) for c in family}
    assert json.loads(fam2.path.read_text())["meta"]["expr"] == "aatb"
    with pytest.raises(ValueError, match="unknown grid"):
        calibrate.calibrate(grid="nope", device="cpu")


def test_calibrate_cli_on_the_cpu(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.core.calibrate", "--backend",
           "torch", "--device", "cpu", "--grid", "tiny", "--reps", "1",
           "--out", str(tmp_path), "--quiet"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "calibrated 18 kernel shapes on torch/cpu/float32" in proc.stdout
    files = list(tmp_path.glob("profile-*.json"))
    assert [f.name for f in files] == ["profile-torch-cpu-float32.json"]
    assert json.loads(files[0].read_text())["version"] == 1
    # the reference reads what the port's CLI wrote
    read, fp = ref_store.load_profile(files[0])
    assert fp.device == "cpu" and len(read.table) == 18


# --------------------------------------------------- the Hopper model --

def test_hopper_profile_charges_the_wrappers_launch_plus_overhead():
    prof = AnalyticalHopperProfile(sms=132)
    over = perfmodel.H100_SXM.kernel_overhead_s
    for m, n, k in ((1200, 400, 1200), (400, 1200, 400), (33, 700, 1001)):
        cfg = gemm_mod.gemm_config(m, n, k, 132)
        assert prof.time(gemm(m, n, k)) == \
            gemm_mod.gemm_cost(m, n, cfg, 132) * 1e-6 + over
    for m, k in ((1200, 800), (400, 1200)):
        cfg = syrk_mod.syrk_config(m, k, 132)
        assert prof.time(syrk(m, k)) == \
            syrk_mod.syrk_cost(m, cfg, 132) * 1e-6 + over
    for m, n in ((1200, 400), (800, 800)):
        cfg = symm_mod.symm_config(m, n, 132)
        assert prof.time(symm(m, n)) == \
            gemm_mod.gemm_cost(m, n, cfg, 132) * 1e-6 + over
    assert prof.time(tri2full(1200)) == 1200 ** 2 * 4 / 3.35e12 + over
    assert prof.time(tri2full(1200), dtype_bytes=8) == \
        1200 ** 2 * 8 / 3.35e12 + over
    assert prof.peak() == 67e12
    with pytest.raises(ValueError):
        prof.time(KernelCall("chain", (1, 2)))


def test_hopper_profile_reads_the_sm_count_only_from_a_card():
    prof = AnalyticalHopperProfile()
    if torch.cuda.is_available():
        assert prof.sms == torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
    else:
        assert prof.sms == gemm_mod.SMS == 132
    # fewer SMs: more waves, never less time
    assert AnalyticalHopperProfile(sms=66).time(gemm(1200, 1200, 1200)) > \
        AnalyticalHopperProfile(sms=132).time(gemm(1200, 1200, 1200))


@pytest.mark.parametrize("kind", ["gemm", "syrk", "symm"])
def test_hopper_profile_is_monotone_in_each_dim(kind):
    """More work never costs less, except along the contraction (symm's
    is m): the wrapper admits a 3- and a 4-way split only from 288 and
    384 on (slices at least 96 deep), so there, and only there, the
    modeled time may drop — by less than 11 %."""
    prof = AnalyticalHopperProfile(sms=132)
    shapes = {"gemm": [(m, n, k) for m in (64, 400, 1200)
                       for n in (64, 700) for k in (128, 1000)],
              "syrk": [(m, k) for m in (64, 400, 1200) for k in (128, 1000)],
              "symm": [(m, n) for m in (64, 400, 1200) for n in (64, 700)]}
    splits = (3 * gemm_mod.MIN_SLICE, 4 * gemm_mod.MIN_SLICE)
    for base in shapes[kind]:
        for axis in range(len(base)):
            contraction = (kind, axis) in (("gemm", 2), ("syrk", 1),
                                           ("symm", 0))
            prev = None
            for d in range(1, 1300):
                dims = base[:axis] + (d,) + base[axis + 1:]
                t = prof.time(KernelCall(kind, dims))
                if prev is not None and t < prev:
                    assert contraction and d in splits, (kind, dims)
                    assert t > 0.89 * prev
                prev = t


def test_hybrid_falls_back_to_the_hopper_model_on_an_empty_table():
    hopper = AnalyticalHopperProfile()
    for profile in (None, TableProfile(67e12)):
        hy = as_hybrid(profile)
        assert isinstance(hy.analytical, AnalyticalHopperProfile)
        for call in QUERIES:
            assert hy.source(call) == "analytical"
            assert hy.time(call, 4) == hopper.time(call, 4)
    # with a calibration, near shapes come from the table
    hy = as_hybrid(_sample_profile())
    assert hy.source(gemm(130, 130, 130)) == "table"
    assert hy.source(gemm(8192, 8192, 8192)) == "analytical"


def test_cuda_backend_fingerprint_is_the_calibration_key():
    backend = CudaBackend(device="cpu")
    assert backend.fingerprint() == current_fingerprint(
        backend="cuda", dtype="float32", device="cpu")
