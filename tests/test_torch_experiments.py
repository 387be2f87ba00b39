"""The paper's three experiments on every engine of the port, and their
drivers (``repro_torch.benchmarks.experiment{1,2,3}``), on the CPU.

Experiment 1 on the planted ``MaskRunner`` (``core/synthetic.py``:
times are exact functions of the point, so no tolerance) must draw the
reference's samples and find its anomalies, serially and over two
spawned worker processes. On real backends the engines must draw the
same points; times are not compared. The drivers run at a tiny scale on
``numpy`` with a 64 KiB cache flush in place of the 64 MB one.
"""

import functools
import json
import zlib

import numpy as np
import pytest

from repro.core import experiments as ref_experiments
from repro.core import synthetic as ref_synthetic
from repro.core.expressions import get_spec as ref_get_spec
from repro.core.perfmodel import TableProfile as RefTableProfile
from repro.core.sweep import sweep as ref_sweep
from repro_torch.benchmarks import common, experiment1, experiment2, experiment3
from repro_torch.core import experiments, synthetic
from repro_torch.core.backends import (CacheFlusher, make_backend,
                                       numpy_backend, register_torch_backends)
from repro_torch.core.expressions import get_spec
from repro_torch.core.perfmodel import TableProfile
from repro_torch.core.sweep import AnomalyAtlas, atlas_path, sweep

register_torch_backends()

KW = dict(box=(20, 600), n_anomalies=6, max_samples=60, seed=4, batch=10)


def _planted():
    mask = dict(center=(300, 300), radius=150.0)
    return (synthetic.PlantedSpec(), synthetic.BlobMask(**mask),
            ref_synthetic.PlantedSpec(), ref_synthetic.BlobMask(**mask))


def _found(res):
    return res.samples, [a.point for a in res.anomalies]


def test_experiment1_serially_equals_the_references():
    spec, mask, ref_spec, ref_mask = _planted()
    mine = experiments.experiment1_random_search(
        spec, synthetic.MaskRunner(mask), **KW)
    theirs = ref_experiments.experiment1_random_search(
        ref_spec, ref_synthetic.MaskRunner(ref_mask), **KW)
    assert _found(mine) == _found(theirs) and mine.anomalies


def test_experiment1_on_two_worker_processes_equals_the_references():
    """One pool of two spawned workers serves every batch."""
    spec, mask, ref_spec, ref_mask = _planted()
    mine = experiments.experiment1_random_search(
        spec, backend="process", shards=2,
        runner_factory=functools.partial(synthetic.MaskRunner, mask), **KW)
    theirs = ref_experiments.experiment1_random_search(
        ref_spec, ref_synthetic.MaskRunner(ref_mask), **KW)
    assert _found(mine) == _found(theirs)


@pytest.mark.parametrize("engine", ["process", "devices"])
def test_a_runner_configures_only_the_serial_engine(engine):
    spec, mask, ref_spec, ref_mask = _planted()
    with pytest.raises(ValueError, match="only configures the serial"):
        experiments.experiment1_random_search(
            spec, synthetic.MaskRunner(mask), backend=engine, **KW)
    with pytest.raises(ValueError, match="only configures the serial"):
        ref_experiments.experiment1_random_search(
            ref_spec, ref_synthetic.MaskRunner(ref_mask), backend="process",
            **KW)


def _drawn(tmp_path, label, measured_on, **kw):
    """Experiment 1 on aatb into an atlas of its own; the points drawn."""
    spec = get_spec("aatb")
    fp = make_backend(measured_on, device="cpu", reps=1,
                      flush_cache=False).fingerprint()
    with AnomalyAtlas(atlas_path(spec.name, fp, 0.10, tmp_path / label), fp,
                      spec.name, 0.10) as atlas:
        res = experiments.experiment1_random_search(
            spec, box=(4, 16), n_anomalies=100, max_samples=20, seed=1,
            atlas=atlas, device="cpu", **kw)
        assert res.samples == 20
        return sorted(r.point for r in atlas.records())


def test_every_engine_draws_the_same_points(tmp_path):
    serial = _drawn(tmp_path, "serial", "numpy", runner=make_backend(
        "numpy", reps=1, flush_cache=False))
    pooled = _drawn(tmp_path, "pool", "numpy", backend="process", shards=2,
                    runner_factory=functools.partial(
                        make_backend, "numpy", reps=1, flush_cache=False))
    devices = _drawn(tmp_path, "devices", "torch", backend="devices",
                     exec_backend="torch")
    assert serial == pooled == devices and len(serial) >= 15


def test_the_devices_engine_takes_only_a_device_backend():
    with pytest.raises(ValueError, match="runs on the host"):
        experiments.experiment1_random_search(
            get_spec("aatb"), backend="devices", exec_backend="blas",
            device="cpu", max_samples=1)


@pytest.fixture
def small_flush(monkeypatch):
    """numpy's flush over 64 KiB instead of 64 MB, in this process."""
    monkeypatch.setattr(numpy_backend, "CacheFlusher",
                        lambda: CacheFlusher(nbytes=1 << 16))


def test_experiment2_takes_exec_backend(small_flush, monkeypatch):
    built = []
    real = experiments.backend_on

    def spy(name, device, **options):
        built.append(name)
        return real(name, device, **options)

    monkeypatch.setattr(experiments, "backend_on", spy)
    spec = get_spec("aatb")
    seeds = sweep(spec, [(8, 12, 16)], runner=make_backend(
        "numpy", reps=1, flush_cache=False)).records
    res = experiments.experiment2_regions(spec, None, seeds, box=(4, 20),
                                          step=8, exec_backend="numpy",
                                          device="cpu")
    assert built == ["numpy"] and len(res.scans) == spec.ndims
    assert (8, 12, 16) in res.classified


class _Stub:
    """Deterministic times, a pure function of the algorithm and dims."""

    def make_operands(self, alg):
        return {}

    def time_algorithm(self, alg, operands=None, reps=None):
        dims = tuple(c.dims for c in alg.calls)
        return 1e-6 * (1 + zlib.crc32(f"{alg.name}{dims}".encode()) % 97)


def test_experiment3_takes_exec_backend_and_charges_its_element_size():
    """On numpy (float64) the model charges 8 bytes an element, as the
    reference's Experiment 3 does: the same confusion from the same
    covering table, with nothing timed."""
    spec, ref_spec = get_spec("aatb"), ref_get_spec("aatb")
    points = spec.grid("smoke").points()
    classified = {r.point: r for r in sweep(spec, points,
                                            runner=_Stub()).records}
    ref_classified = {r.point: r for r in ref_sweep(
        ref_spec, points, runner=_Stub(), fastpath=False).records}
    rng = np.random.default_rng(0)
    table = {(c.kind, c.dims): float(rng.uniform(1e-6, 1e-4))
             for p in points for a in spec.algorithms(p) for c in a.calls}
    mine = experiments.experiment3_predict_from_benchmarks(
        spec, None, classified, exec_backend="numpy", device="cpu",
        profile=TableProfile(peak_flops=1e11, table=dict(table)))
    theirs = ref_experiments.experiment3_predict_from_benchmarks(
        ref_spec, "numpy", ref_classified,
        profile=RefTableProfile(peak_flops=1e11, table=dict(table)))
    cm, rcm = mine.confusion, theirs.confusion
    assert (cm.tp, cm.fp, cm.fn, cm.tn) == (rcm.tp, rcm.fp, rcm.fn, rcm.tn)
    assert mine.n_calls_measured == theirs.n_calls_measured == 0


# ------------------------------------------------------------- drivers ----


@pytest.fixture
def drivers(tmp_path, monkeypatch, small_flush):
    monkeypatch.setenv("REPRO_ATLAS_DIR", str(tmp_path / "atlas"))
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path / "profiles"))
    monkeypatch.setattr(common, "EXEC_BACKEND", "numpy")
    monkeypatch.setattr(common, "SHARDS", 1)
    return tmp_path


def _rows(out, prefix):
    rows = [line.split(",", 2) for line in out.splitlines()
            if line.startswith(prefix)]
    assert rows, out
    for _, us, derived in rows:
        float(us)
        assert derived.endswith("fp=numpy-x86_64-float64") or \
            derived.split(";fp=")[1].startswith("numpy-")
    return rows


def test_experiment1_driver_runs_and_resumes(drivers, capsys):
    scale = ((8, 24), 2, 12, 2, 12, 1)
    experiment1.main(scale)
    first = capsys.readouterr()
    assert len(_rows(first.out, "exp1_")) == 2
    assert "atlas held 0 instances going in" in first.err
    experiment1.main(scale)
    assert "atlas held 0 instances going in" not in capsys.readouterr().err


def test_experiment2_driver(drivers, capsys):
    experiment2.main(((8, 24), 2, 1, 10, 8))
    out = capsys.readouterr().out
    assert _rows(out, "exp2_AATB_")


def test_experiment3_driver_saves_its_profile(drivers, capsys):
    experiment3.main(((8, 24), 2, 1, 10, 8))
    out = capsys.readouterr().out
    (row,) = _rows(out, "exp3_AATB_recall")
    if "no_anomalies" not in row[2]:
        (path,) = (drivers / "profiles").glob("profile-numpy-*.json")
        doc = json.loads(path.read_text())
        assert doc["meta"] == {"source": "experiment3:AATB"}
        assert doc["fingerprint"]["dtype"] == "float64"


def test_engine_kwargs_follow_the_backend(monkeypatch):
    monkeypatch.setattr(common, "SHARDS", 1)
    assert common.engine_kwargs(3) == {}
    monkeypatch.setattr(common, "SHARDS", 2)
    monkeypatch.setattr(common, "EXEC_BACKEND", "numpy")
    kw = common.engine_kwargs(3)
    assert (kw["backend"], kw["shards"]) == ("process", 2)
    assert kw["runner_factory"].keywords == {"reps": 3}
    monkeypatch.setattr(common, "EXEC_BACKEND", "cuda")
    assert common.engine_kwargs(3) == {
        "backend": "devices", "shards": 2, "exec_backend": "cuda",
        "device": common.DEVICE}


def test_a_sharded_driver_run_uses_the_worker_pool(drivers, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(common, "SHARDS", 2)
    res = experiment1.run_spec(get_spec("aatb"), (8, 20), 2, 10, reps=1)
    assert res.samples == 10
    assert _rows(capsys.readouterr().out, "exp1_AATB_abundance")
