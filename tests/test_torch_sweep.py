"""The port's slice as a whole against the JAX package, on the CPU.

Same seed, same operands (bit for bit); every algorithm of ``aatb`` and
``abcd`` executed by ``CudaBackend(device="cpu")`` against the reference
``PallasBackend`` (Pallas interpret mode) at rtol=1e-4, atol=1e-2 (the
abcd products reach magnitudes ~1e3, where float32 rounding in another
summation order is ~1e-4 absolute); the atlas the port writes is one the
reference reads; the CLI resumes; a resume across a change of kernel
sources or of the fusion switch is refused.
"""

import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from repro.core.backends.jax_backend import PallasBackend
from repro.core.evaluate import load_atlas_records
from repro.core.expressions import get_spec as ref_get_spec
from repro_torch.core.backends import CudaBackend, operands_from_numpy
from repro_torch.core.expressions import get_spec
from repro_torch.core.fingerprint import HardwareFingerprint
from repro_torch.core.sweep import AnomalyAtlas, AtlasError, atlas_path, sweep
from repro_torch.kernels import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("name,point", [("aatb", (130, 70, 90)),
                                        ("abcd", (60, 130, 70, 90, 50))])
def test_every_algorithm_matches_pallas_on_identical_operands(name, point):
    ref_backend = PallasBackend(seed=0, tuning=None)
    port = CudaBackend(device="cpu", seed=0)
    ref_algos = ref_get_spec(name).algorithms(point)
    port_algos = get_spec(name).algorithms(point)
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
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cpu_sweep_atlas_is_read_by_the_reference(tmp_path):
    spec = get_spec("aatb")
    runner = CudaBackend(device="cpu", reps=1, seed=0)
    fp = runner.fingerprint()
    assert fp == HardwareFingerprint("cuda", "cpu", "float32")
    path = atlas_path(spec.name, fp, 0.10, tmp_path)
    points = spec.grid("smoke").points()
    res = sweep(spec, points, runner=runner,
                atlas=AnomalyAtlas(path, fp, spec.name, 0.10))
    assert res.n_measured == 8 and res.n_skipped == 0
    header = json.loads(path.read_text().splitlines()[0])
    assert header["kernels"] == _build.source_hash()
    assert header["fusion"] is True
    replay = load_atlas_records(path)   # the reference ignores the new keys
    assert replay.spec_name == "AATB" and not replay.legacy
    assert replay.fingerprint.to_dict() == fp.to_dict()
    assert {r.point: r.times for r in replay.records} == \
        {r.point: r.times for r in res.records}
    again = sweep(spec, points, runner=runner,
                  atlas=AnomalyAtlas(path, fp, spec.name, 0.10))
    assert again.n_measured == 0 and again.n_skipped == 8


def test_atlas_never_mixes_devices_and_survives_a_torn_tail(tmp_path):
    spec = get_spec("aatb")
    cpu = HardwareFingerprint("cuda", "cpu", "float32")
    card = HardwareFingerprint("cuda", "NVIDIA H100 80GB HBM3", "float32")
    assert atlas_path(spec.name, cpu, 0.1, tmp_path) != \
        atlas_path(spec.name, card, 0.1, tmp_path)
    path = tmp_path / "atlas.jsonl"
    runner = CudaBackend(device="cpu", reps=1, seed=1)
    sweep(spec, [(32, 32, 32)], runner=runner,
          atlas=AnomalyAtlas(path, cpu, spec.name, 0.10))
    with pytest.raises(AtlasError, match="was swept on"):
        AnomalyAtlas(path, card, spec.name, 0.10)
    with path.open("a") as f:
        f.write('{"point": [64, 64')           # a kill mid-write
    atlas = AnomalyAtlas(path, cpu, spec.name, 0.10)
    assert len(atlas) == 1 and atlas.skipped_lines == 1
    sweep(spec, [(64, 64, 64)], runner=runner, atlas=atlas)
    reread = AnomalyAtlas(path, cpu, spec.name, 0.10)
    assert sorted(r.point for r in reread.records()) == [(32, 32, 32),
                                                         (64, 64, 64)]
    assert json.loads(path.read_text().splitlines()[0])["kind"] == "header"


def test_cli_measures_then_resumes(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.core.sweep", "--expr", "aatb",
           "--grid", "smoke", "--backend", "cuda", "--device", "cpu",
           "--reps", "1", "--seed", "0", "--atlas-dir", str(tmp_path),
           "--quiet"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    first = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=120)
    assert first.returncode == 0, first.stderr
    assert re.search(r"points=8 measured=8 skipped=0", first.stdout)
    assert "anomalies:" in first.stdout
    second = subprocess.run(cmd, env=env, capture_output=True, text=True,
                            timeout=120)
    assert second.returncode == 0, second.stderr
    assert re.search(r"points=8 measured=0 skipped=8", second.stdout)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_NO_FUSION", None)
    return subprocess.run([sys.executable, "-m", "repro_torch.core.sweep",
                           *args], env=env, capture_output=True, text=True,
                          timeout=120)


def test_cli_lists_the_reference_families():
    from repro.core.expressions import registered_names
    out = _cli("--list-exprs")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == registered_names()
    assert len(out.stdout.split()) == 10
    helped = _cli("--help")
    assert all(f"  {name} " in helped.stdout for name in registered_names())


@pytest.mark.parametrize("no_fusion", [False, True])
def test_cli_sweeps_abab_resumes_and_the_reference_reads_it(tmp_path,
                                                            no_fusion):
    args = ["--expr", "abab", "--grid", "smoke", "--device", "cpu", "--reps",
            "1", "--seed", "0", "--atlas-dir", str(tmp_path), "--quiet"]
    if no_fusion:
        args.append("--no-fusion")
    first = _cli(*args)
    assert first.returncode == 0, first.stderr
    assert re.search(r"points=8 measured=8 skipped=0", first.stdout)
    second = _cli(*args)
    assert second.returncode == 0, second.stderr
    assert re.search(r"points=8 measured=0 skipped=8", second.stdout)
    (path,) = tmp_path.glob("atlas-abab-*.jsonl")
    replay = load_atlas_records(path)
    assert replay.spec_name == "ABAB" and len(replay.records) == 8
    names = [a.name for a in ref_get_spec("abab").algorithms((64, 64, 64))]
    assert all(sorted(r.times) == sorted(names) for r in replay.records)


def _swept_atlas(path, points, seed=0):
    """An aatb atlas of ``points`` on the cuda backend's plain versions,
    and the fingerprint it was written under."""
    spec = get_spec("aatb")
    runner = CudaBackend(device="cpu", reps=1, seed=seed)
    fp = runner.fingerprint()
    sweep(spec, points, runner=runner,
          atlas=AnomalyAtlas(path, fp, spec.name, 0.10))
    return fp


def test_resume_under_other_kernel_sources_is_refused(tmp_path,
                                                      monkeypatch):
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    path = tmp_path / "atlas.jsonl"
    fp = _swept_atlas(path, [(32, 32, 32)])
    AnomalyAtlas(path, fp, "AATB", 0.10)       # the same program resumes
    monkeypatch.setattr(_build, "source_hash", lambda: "0123456789abcdef")
    with pytest.raises(AtlasError, match=r"kernels='[0-9a-f]{16}' fusion="
                                         r"True, but this process runs "
                                         r"kernels='0123456789abcdef'"):
        AnomalyAtlas(path, fp, "AATB", 0.10)


def test_resume_under_no_fusion_after_a_fused_run_is_refused(tmp_path):
    args = ["--expr", "aatb", "--grid", "smoke", "--device", "cpu",
            "--reps", "1", "--seed", "0", "--atlas-dir", str(tmp_path),
            "--quiet"]
    assert _cli(*args).returncode == 0
    again = _cli(*args, "--no-fusion")
    assert again.returncode != 0
    assert "AtlasError" in again.stderr and "fusion=True" in again.stderr \
        and "fusion=False" in again.stderr
    assert re.search(r"points=8 measured=0 skipped=8", _cli(*args).stdout)


def test_atlas_without_the_program_keys_is_refused(tmp_path, monkeypatch):
    """An atlas from before the header named its kernels and fusion
    setting: its program is unknown, so it is not resumed."""
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    path = tmp_path / "atlas.jsonl"
    fp = _swept_atlas(path, [(32, 32, 32)])
    lines = path.read_text().splitlines()
    header = json.loads(lines[0])
    for key in ("kernels", "fusion"):
        stripped = {k: v for k, v in header.items() if k != key}
        path.write_text("\n".join([json.dumps(stripped)] + lines[1:]) + "\n")
        with pytest.raises(AtlasError, match="start a fresh atlas"):
            AnomalyAtlas(path, fp, "AATB", 0.10)


def _atlas_merge():
    """tools/atlas_merge.py, loaded as tests/test_adaptive.py loads it."""
    if "atlas_merge" in sys.modules:
        return sys.modules["atlas_merge"]
    spec = importlib.util.spec_from_file_location(
        "atlas_merge", ROOT / "tools" / "atlas_merge.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["atlas_merge"] = mod   # its dataclasses look the module up
    spec.loader.exec_module(mod)
    return mod


def test_atlas_merge_refuses_shards_of_other_kernel_sources(tmp_path,
                                                           monkeypatch):
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    merge = _atlas_merge()
    first, second = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    _swept_atlas(first, [(32, 32, 32)])
    _swept_atlas(second, [(64, 64, 64)])
    assert merge.merge_shards([first, second]).n_records == 2
    monkeypatch.setattr(_build, "source_hash", lambda: "0123456789abcdef")
    third = tmp_path / "c.jsonl"
    _swept_atlas(third, [(64, 64, 64)])
    with pytest.raises(merge.MergeError, match=r"\['kernels'\]"):
        merge.merge_shards([first, third])
