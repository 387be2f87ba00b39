"""The port's slice as a whole against the JAX package, on the CPU.

Same seed, same operands (bit for bit); every algorithm of ``aatb`` and
``abcd`` executed by ``CudaBackend(device="cpu")`` against the reference
``PallasBackend`` (Pallas interpret mode) at rtol=1e-4, atol=1e-2 (the
abcd products reach magnitudes ~1e3, where float32 rounding in another
summation order is ~1e-4 absolute); the atlas the port writes is one the
reference reads; the CLI resumes.
"""

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
    replay = load_atlas_records(path)
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
