"""The port's ``blas`` and ``numpy`` backends, and the ``torch`` backend's
dtypes, against the JAX package's backends on the CPU.

Tolerances, each relative to max|value| of the reference's result:

* ``blas`` / ``numpy`` against the reference's on identical seeded
  operands: max|d| <= 1e-12·max|value|, and bitwise equality is expected
  (the same scipy and numpy calls on the same float64 bits);
* ``torch`` in float64 against ``blas``: 1e-10·max|value|;
* ``torch`` in float32 against the reference's ``jax`` in float32:
  1e-3 + 1e-4·max|value| (``chip_smoke.py`` phase 5's limit);
* ``torch`` in bfloat16 against ``jax`` in bfloat16 and against ``blas``:
  2^-6·max|value| (``PERF.md`` §2): inputs, each intermediate and the
  output are rounded to bf16, 2^-9 relative each, while the products
  accumulate in float32; the largest error seen against ``blas`` at the
  sizes of ``chip_smoke.py`` phase 12 was 5.1e-3·max|value|.

The cache flush is 64 MB a repetition, so the tests pass
``flush_cache=False`` or a small :class:`CacheFlusher`, except where a
CLI is run as a user runs it.
"""

import argparse
import json
import platform
import re

import numpy as np
import pytest
import torch

from repro.core.backends import CacheFlusher as RefCacheFlusher
from repro.core.backends import get_backend as ref_get_backend
from repro.core.backends import reference_execute as ref_reference_execute
from repro.core.backends.jax_backend import JaxBackend
from repro.core.expressions import get_spec as ref_get_spec
from repro.core.flops import gemm as ref_gemm
from repro.core.profile_store import HardwareFingerprint as RefFingerprint
from repro.core.profile_store import current_fingerprint as ref_fingerprint
from repro.core.profile_store import load_profile as ref_load_profile
from repro.core.sweep import AnomalyAtlas as RefAnomalyAtlas
from repro_torch.core import calibrate, runners
from repro_torch.core import sweep as sweep_mod
from repro_torch.core.backends import (BlasBackend, CacheFlusher, CudaBackend,
                                       NumpyBackend, TorchBackend,
                                       backend_on, backend_shard_mode,
                                       get_backend, make_backend,
                                       operands_from_numpy, reference_execute,
                                       register_torch_backends,
                                       registered_backends, timing_mode)
from repro_torch.core.expressions import get_spec, registered_names
from repro_torch.core.flops import gemm
from repro_torch.core.profile_store import current_fingerprint
from repro_torch.core.sweep import AnomalyAtlas, AtlasError, atlas_path, sweep

register_torch_backends()

#: One small point per family (dims in [4, 40]).
POINTS = {
    "aatb": (40, 24, 32), "abcd": (24, 40, 16, 32, 24),
    "abcde": (20, 36, 16, 28, 12, 24), "abtb": (36, 20, 28),
    "btsb": (36, 20), "atab": (36, 20, 28), "abab": (36, 20, 28),
    "decproj": (4, 36, 20), "decattn": (4, 36, 20, 28),
    "decmlp": (4, 36, 20)}
F64_TOL = 1e-10
BF16_TOL = 2 ** -6


def _max_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def test_points_cover_every_family():
    assert sorted(POINTS) == registered_names()
    for name, point in POINTS.items():
        assert len(point) == get_spec(name).ndims


# ------------------------------------------- the host backends, bit for bit --


@pytest.mark.parametrize("name", sorted(POINTS))
@pytest.mark.parametrize("backend", ["blas", "numpy"])
def test_every_algorithm_equals_the_references(backend, name):
    mine = get_backend(backend, reps=1, flush_cache=False, seed=0)
    theirs = ref_get_backend(backend, reps=1, flush_cache=False, seed=0)
    point = POINTS[name]
    algos = get_spec(name).algorithms(point)
    ref_algos = ref_get_spec(name).algorithms(point)
    assert [a.name for a in algos] == [a.name for a in ref_algos]
    for alg, ref_alg in zip(algos, ref_algos):
        ops, ref_ops = mine.make_operands(alg), theirs.make_operands(ref_alg)
        assert ops.keys() == ref_ops.keys()
        for base, arr in ref_ops.items():       # same seed -> same bits
            np.testing.assert_array_equal(ops[base], arr)
            assert ops[base].dtype == np.float64
            assert ops[base].flags.f_contiguous == arr.flags.f_contiguous
        got, want = mine.execute(alg, ops), theirs.execute(ref_alg, ref_ops)
        assert _max_err(got, want) <= 1e-12 * float(np.abs(want).max())
        np.testing.assert_array_equal(got, want, err_msg=alg.name)
        np.testing.assert_array_equal(reference_execute(alg, ops),
                                      ref_reference_execute(ref_alg, ref_ops))


@pytest.mark.parametrize("backend", ["blas", "numpy"])
def test_one_flush_per_repetition_as_the_reference(backend):
    """A small CacheFlusher(nbytes=64 KiB), counted: time_algorithm and
    benchmark_call flush once before each timed repetition (the warm-up
    is not flushed), in both packages."""
    counts = []
    for build, flusher, spec, call in (
            (get_backend, CacheFlusher, get_spec, gemm),
            (ref_get_backend, RefCacheFlusher, ref_get_spec, ref_gemm)):
        alg = spec("aatb").algorithms((16, 8, 12))[0]
        runner = build(backend, reps=4, flush_cache=False, seed=0)
        runner.flusher = flusher(nbytes=1 << 16)
        seen = []
        flush = runner.flusher.flush
        runner.flusher.flush = lambda: seen.append(1) or flush()
        runner.time_algorithm(alg)
        runner.benchmark_call(call(8, 8, 8), reps=2)
        counts.append(len(seen))
    assert counts == [6, 6]


def test_no_flush_leaves_no_flusher():
    for name in ("blas", "numpy"):
        assert make_backend(name, flush_cache=False).flusher is None
        assert make_backend(name, device="cuda", dtype="float64",
                            flush_cache=True).flusher is not None
    args = argparse.Namespace(reps=1, no_flush=True, seed=0, shards=1,
                              device="cuda")
    assert sweep_mod._engine_config("blas", args)["runner"].flusher is None
    args.shards = 2
    config = sweep_mod._engine_config("numpy", args)
    assert config["backend"] == "process" and config["shards"] == 2
    assert config["runner_factory"]().flusher is None


@pytest.mark.parametrize("backend", ["blas", "numpy"])
def test_host_fingerprint_equals_the_references(backend):
    """The host's ISA, whatever ``device`` says: no card is needed."""
    want = ref_fingerprint(backend=backend, dtype="float64").to_dict()
    assert want["device"] == platform.machine()
    for device in ("cuda", "cpu"):
        assert current_fingerprint(backend=backend, dtype="float64",
                                   device=device).to_dict() == want
    runner = get_backend(backend, flush_cache=False)
    assert runner.fingerprint().to_dict() == want
    assert backend_shard_mode(backend) == "process"


def test_registry_holds_the_four_backends():
    assert registered_backends() == ["blas", "cuda", "numpy", "torch"]
    assert isinstance(backend_on("blas", "cuda", reps=2), BlasBackend)
    assert isinstance(backend_on("torch", "cpu"), TorchBackend)
    assert isinstance(make_backend("numpy", device="cuda", reps=1),
                      NumpyBackend)
    for name in ("blas", "numpy"):
        assert backend_shard_mode(name) == "process"
        assert get_backend(name, flush_cache=False).dtype == "float64"
    with pytest.raises(ValueError, match="float32"):
        BlasBackend(dtype="float32")


def test_runners_keep_the_reference_names():
    assert runners.BlasRunner is BlasBackend
    assert runners.reference_execute is reference_execute
    assert runners.CacheFlusher is CacheFlusher
    assert not hasattr(runners, "JaxRunner")


def test_timing_mode_follows_the_backend():
    assert timing_mode("x86_64", "blas") == "eager"
    assert timing_mode("x86_64", "numpy") == "eager"
    assert timing_mode("NVIDIA H100 80GB HBM3", "cuda") == "graph"
    assert timing_mode("cpu", "torch") == "eager"
    assert timing_mode("NVIDIA H100 80GB HBM3", "unregistered") == "graph"


# ------------------------------------------------------- atlas and CLIs ----


def test_blas_atlas_header_and_the_reference_reads_it(tmp_path):
    spec = get_spec("aatb")
    runner = BlasBackend(reps=1, flush_cache=False, seed=0)
    fp = runner.fingerprint()
    path = atlas_path(spec.name, fp, 0.10, tmp_path)
    points = spec.grid("smoke").points()
    res = sweep(spec, points, runner=runner,
                atlas=AnomalyAtlas(path, fp, spec.name, 0.10))
    assert res.n_measured == len(points)
    header = json.loads(path.read_text().splitlines()[0])
    assert header["fingerprint"] == ref_fingerprint("blas", "float64") \
        .to_dict()
    assert (header["timing"], header["kernels"], header["fusion"],
            header["tuning"]) == ("eager", None, False, None)
    theirs = RefAnomalyAtlas(path, RefFingerprint(**fp.to_dict()), spec.name,
                             0.10)
    assert len(theirs) == len(points)
    for r in res.records:
        ref = theirs.get(r.point)
        assert ref.times == r.times and ref.cls.fastest == r.cls.fastest
    # A resume under another header is refused.
    lines = path.read_text().splitlines()
    lines[0] = json.dumps({**header, "timing": "graph"})
    path.write_text("\n".join(lines) + "\n")
    with pytest.raises(AtlasError):
        AnomalyAtlas(path, fp, spec.name, 0.10)


@pytest.mark.parametrize("backend,want", [("blas", 8), ("numpy", 8),
                                          ("torch", 4)])
def test_predict_charges_the_backends_element_size(backend, want, tmp_path,
                                                   monkeypatch):
    """--mode predict charges 8 bytes an element on blas and numpy, as
    the reference does (``8 if dtype == "float64" else 4``)."""
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path / "profiles"))
    charged = []
    real = sweep_mod.predict_classifications

    def spy(*args, **kwargs):
        charged.append(kwargs["dtype_bytes"])
        return real(*args, **kwargs)

    monkeypatch.setattr(sweep_mod, "predict_classifications", spy)
    assert sweep_mod.main(["--backend", backend, "--device", "cpu", "--expr",
                           "aatb", "--grid", "8,16", "--mode", "predict",
                           "--reps", "1", "--no-flush", "--atlas-dir",
                           str(tmp_path), "--quiet"]) == 0
    assert charged == [want]
    assert sweep_mod.element_bytes("float64") == 8
    assert sweep_mod.element_bytes("bfloat16") == 4


def test_compare_blas_with_torch_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path / "profiles"))
    assert sweep_mod.main(["--compare-backends", "blas,torch", "--device",
                           "cpu", "--expr", "aatb", "--grid", "8,16",
                           "--reps", "1", "--seed", "0", "--atlas-dir",
                           str(tmp_path), "--quiet"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"compare AATB/\S+ \[blas vs torch\]: points=8 "
                     r"fastest-differs=\d+", out)
    assert re.search(r"\[blas\]: points=8 measured=8 .* in \d", out)
    names = sorted(p.name for p in tmp_path.glob("atlas-*.jsonl"))
    assert names == [f"atlas-aatb-t0p1-blas-{platform.machine().lower()}"
                     "-float64.jsonl", "atlas-aatb-t0p1-torch-cpu-float32.jsonl"]


def test_sharded_blas_sweep_runs_in_worker_processes(tmp_path, capsys):
    assert sweep_mod.main(["--backend", "blas", "--expr", "aatb", "--grid",
                           "8,16", "--reps", "1", "--no-flush", "--shards",
                           "2", "--seed", "0", "--atlas-dir", str(tmp_path),
                           "--quiet"]) == 0
    assert re.search(r"points=8 measured=8 skipped=0",
                     capsys.readouterr().out)


@pytest.mark.parametrize("backend,dtype", [
    ("blas", None), ("numpy", None), ("torch", "bfloat16"),
    ("torch", "float64"), ("torch", "float16")])
def test_calibrate_writes_the_backends_fingerprint(backend, dtype, tmp_path):
    argv = ["--backend", backend, "--device", "cpu", "--grid", "tiny",
            "--reps", "1", "--out", str(tmp_path), "--quiet"]
    assert calibrate.main(argv + (["--dtype", dtype] if dtype else [])) == 0
    (path,) = tmp_path.glob("profile-*.json")
    fp = json.loads(path.read_text())["fingerprint"]
    if backend == "torch":
        assert fp == {"backend": "torch", "device": "cpu", "dtype": dtype}
    else:
        assert fp == ref_fingerprint(backend, "float64").to_dict()
    profile, _ = ref_load_profile(path)      # the reference reads it
    assert len(profile.table) == 18


def test_cuda_backend_measures_only_float32(capsys):
    with pytest.raises(SystemExit) as exc:
        calibrate.main(["--backend", "cuda", "--dtype", "bfloat16",
                        "--device", "cpu", "--grid", "tiny"])
    assert exc.value.code == 2
    assert "measures float32; got --dtype bfloat16" in capsys.readouterr().err
    with pytest.raises(ValueError, match="bfloat16"):
        calibrate.calibrate(backend="cuda", dtype="bfloat16", device="cpu",
                            grid="tiny", save=False)
    assert CudaBackend.dtypes == ("float32",)
    assert TorchBackend.dtypes == ("float64", "float32", "bfloat16",
                                   "float16")
    with pytest.raises(ValueError, match="'int8'"):
        TorchBackend(device="cpu", dtype="int8")


def test_torch_refuses_an_operand_of_another_dtype():
    backend = TorchBackend(device="cpu", dtype="bfloat16", seed=0)
    alg = get_spec("aatb").algorithms((16, 8, 12))[0]
    ops = backend.make_operands(alg)
    assert all(t.dtype == torch.bfloat16 for t in ops.values())
    backend.execute(alg, ops)
    with pytest.raises(ValueError, match="not cast"):
        backend.execute(alg, {k: v.float() for k, v in ops.items()})


def test_operands_from_numpy_takes_a_dtype():
    ops = {0: np.arange(6.0).reshape(2, 3)}
    assert operands_from_numpy(ops, "cpu")[0].dtype == torch.float32
    got = operands_from_numpy(ops, "cpu", dtype=torch.float64)[0]
    assert got.dtype == torch.float64 and bool((got.numpy() == ops[0]).all())


# ------------------------------------------------ the torch backend's dtypes --


@pytest.mark.parametrize("name", ["aatb", "abcd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_matches_jax_in(dtype, name):
    mine = TorchBackend(device="cpu", dtype=dtype, seed=0)
    theirs = JaxBackend(dtype=dtype, seed=0)
    point = POINTS[name]
    for alg, ref_alg in zip(get_spec(name).algorithms(point),
                            ref_get_spec(name).algorithms(point)):
        got = mine.execute(alg, mine.make_operands(alg))
        want = np.asarray(theirs.execute(ref_alg,
                                         theirs.make_operands(ref_alg)),
                          dtype=np.float64)
        assert got.dtype == mine.torch_dtype
        scale = float(np.abs(want).max())
        limit = 1e-3 + 1e-4 * scale if dtype == "float32" \
            else BF16_TOL * scale
        assert _max_err(got.double().numpy(), want) <= limit, alg.name


@pytest.mark.parametrize("name", ["aatb", "abcd"])
@pytest.mark.parametrize("dtype,tol", [("float64", F64_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_torch_matches_blas_in(dtype, tol, name):
    mine = TorchBackend(device="cpu", dtype=dtype, seed=0)
    blas = BlasBackend(reps=1, flush_cache=False, seed=0)
    for alg in get_spec(name).algorithms(POINTS[name]):
        want = blas.execute(alg, blas.make_operands(alg))
        got = mine.execute(alg, mine.make_operands(alg)).double().numpy()
        assert _max_err(got, want) <= tol * float(np.abs(want).max()), \
            alg.name
