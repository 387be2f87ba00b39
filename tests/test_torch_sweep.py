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
    assert header["timing"] == "eager"   # the CPU times the walk itself
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
    for key in ("kernels", "fusion", "timing"):
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


def test_resume_under_the_other_timing_is_refused(tmp_path, monkeypatch):
    """An atlas timed as replayed graphs (on a card) is not resumed by a
    process that times the eager walk, nor the other way round."""
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    path = tmp_path / "atlas.jsonl"
    fp = _swept_atlas(path, [(32, 32, 32)])
    lines = path.read_text().splitlines()
    header = json.loads(lines[0])
    assert header["timing"] == "eager"
    header["timing"] = "graph"
    path.write_text("\n".join([json.dumps(header)] + lines[1:]) + "\n")
    with pytest.raises(AtlasError, match="the atlas was timed 'graph', this "
                                         "process times 'eager'"):
        AnomalyAtlas(path, fp, "AATB", 0.10)
    assert len(load_atlas_records(path).records) == 1   # the reference reads it


def test_timing_mode_follows_the_device():
    from repro_torch.core.backends import timing_mode
    assert timing_mode("cpu") == "eager"
    assert timing_mode("NVIDIA H100 80GB HBM3") == "graph"
    assert CudaBackend(device="cpu").timing == "eager"


def test_backend_protocol_hooks_match_the_reference():
    from repro.core.backends import base as ref_base
    from repro_torch.core.backends import (TorchBackend, backend_default_dtype,
                                           backend_shard_mode, make_backend,
                                           register_torch_backends)
    from repro_torch.core.backends import base as port_base
    register_torch_backends()
    for hook in ("_pre_rep", "_sync", "_timed_callable", "fingerprint_tags",
                 "time_algorithm", "benchmark_call"):
        assert hasattr(port_base.ExecutionBackend, hook)
        assert hasattr(ref_base.ExecutionBackend, hook)
    assert ref_base.ExecutionBackend.shard_mode == \
        port_base.ExecutionBackend.shard_mode == "process"
    # The lenient constructor drops what a backend lacks: --no-flush
    # reaches no device backend, as on the reference's jax/pallas.
    b = make_backend("cuda", device="cpu", reps=2, flush_cache=False, seed=3)
    assert isinstance(b, CudaBackend) and (b.reps, b.seed) == (2, 3)
    assert isinstance(make_backend("torch", device="cpu"), TorchBackend)
    assert ref_base.make_backend("jax", flush_cache=False).reps == 3
    assert b.fingerprint_tags() == ("cuda", "float32")
    assert backend_default_dtype("cuda") == "float32"
    assert backend_shard_mode("cuda") == backend_shard_mode("torch") == \
        "device" == ref_base.backend_shard_mode("pallas")


def test_time_algorithm_times_the_timed_callable():
    """time_algorithm times what _timed_callable returns: one warm-up call,
    then each repetition between _pre_rep and _sync."""
    calls = []

    class Probe(CudaBackend):
        def _pre_rep(self):
            calls.append("pre_rep")

        def _sync(self, out):
            calls.append(("sync", out))
            return out

        def _timed_callable(self, alg, operands):
            return lambda: calls.append("run") or "result"

    probe = Probe(device="cpu", reps=2)
    alg = get_spec("aatb").algorithms((32, 32, 32))[0]
    assert probe.time_algorithm(alg, {}) >= 0
    assert calls == ["run", ("sync", "result")] + 2 * [
        "pre_rep", "run", ("sync", "result")]
    calls.clear()
    probe.benchmark_call(alg.calls[0], reps=1)
    assert calls.count("run") == 2


class _FixedTimes:
    """A runner whose times are a fixed function of the algorithm's name
    and the point (deterministic, one per backend)."""

    def __init__(self, slow_alg: str):
        self.slow_alg = slow_alg

    def make_operands(self, alg):
        return {}

    def time_algorithm(self, alg, operands=None):
        base = alg.flops * 1e-9
        if alg.name.startswith(self.slow_alg) and sum(alg.calls[0].dims) > 200:
            base *= 3.0
        return base


def test_compare_backends_gives_the_references_disagreements():
    from repro.core import sweep as ref_sweep
    from repro_torch.core import sweep as port_sweep
    spec, ref_spec = get_spec("aatb"), ref_get_spec("aatb")
    points = spec.grid("smoke").points() + [(128, 96, 64), (96, 128, 64)]
    runners = {"torch": _FixedTimes("alg1"), "cuda": _FixedTimes("alg5")}
    port = port_sweep.compare_backends(spec, points, {
        n: port_sweep.sweep(spec, points, runner=r) for n, r in
        runners.items()})
    ref = ref_sweep.compare_backends(ref_spec, points, {
        n: ref_sweep.sweep(ref_spec, points, runner=r) for n, r in
        runners.items()})
    assert port.backends == ref.backends == ("torch", "cuda")
    assert port.n_points == ref.n_points == len(points)
    for mine, theirs in ((port.fastest_differs, ref.fastest_differs),
                         (port.anomaly_differs, ref.anomaly_differs)):
        assert [dataclass_tuple(d) for d in mine] == \
            [dataclass_tuple(d) for d in theirs]
    assert port.fastest_differs and port.anomaly_differs
    assert port.fastest_differs_rate == ref.fastest_differs_rate
    with pytest.raises(ValueError, match="two sweeps"):
        port_sweep.compare_backends(spec, points, {})


def dataclass_tuple(d):
    return (d.point, d.fastest, d.is_anomaly, d.time_score)


def test_cli_compare_backends_prints_the_fastest_differs_line(tmp_path):
    out = _cli("--expr", "aatb", "--grid", "smoke", "--device", "cpu",
               "--reps", "1", "--seed", "0", "--atlas-dir", str(tmp_path),
               "--quiet", "--compare-backends", "torch,cuda")
    assert out.returncode == 0, out.stderr
    assert re.search(r"compare AATB/smoke \[torch vs cuda\]: points=8 "
                     r"fastest-differs=\d+ \(\d+\.\d%\) "
                     r"anomaly-verdict-differs=\d+", out.stdout)
    atlases = sorted(p.name for p in tmp_path.glob("atlas-aatb-*.jsonl"))
    assert atlases == ["atlas-aatb-t0p1-cuda-cpu-float32.jsonl",
                       "atlas-aatb-t0p1-torch-cpu-float32.jsonl"]
    for path in tmp_path.glob("atlas-aatb-*.jsonl"):
        assert len(load_atlas_records(path).records) == 8


def test_cli_limit_fresh_and_no_flush(tmp_path):
    args = ["--expr", "aatb", "--grid", "smoke", "--device", "cpu", "--reps",
            "1", "--seed", "0", "--atlas-dir", str(tmp_path), "--quiet",
            "--no-flush"]
    first = _cli(*args, "--limit", "3")
    assert first.returncode == 0, first.stderr
    assert re.search(r"points=3 measured=3 skipped=0", first.stdout)
    rest = _cli(*args)
    assert re.search(r"points=8 measured=5 skipped=3", rest.stdout)
    fresh = _cli(*args, "--fresh", "--limit", "2")
    assert re.search(r"points=2 measured=2 skipped=0", fresh.stdout)
    (path,) = tmp_path.glob("atlas-aatb-*.jsonl")
    assert len(path.read_text().splitlines()) == 3   # header + 2


# ------------------------------------------- the atlas names its tuning --

def _save_table(fp, config):
    from repro_torch.core.tuning import (TunedEntry, TuningTable,
                                         save_tuning_table)
    table = TuningTable()
    table.set("gemm", (32, 32, 32), TunedEntry(
        config=config, seconds=1.0, default_seconds=1.0, timed=1, pruned=0))
    save_tuning_table(table, fp)
    return table


def test_atlas_header_names_the_tuning_table(tmp_path, monkeypatch):
    """``tuning`` is the digest of the table the cuda backend auto-loads
    for the atlas's fingerprint; null without a table, under
    ``REPRO_NO_TUNING`` and on the torch backend."""
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path / "profiles"))
    monkeypatch.delenv("REPRO_NO_TUNING", raising=False)
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    fp = HardwareFingerprint("cuda", "cpu", "float32")

    def header(name):
        path = tmp_path / name
        _swept_atlas(path, [(32, 32, 32)])
        return json.loads(path.read_text().splitlines()[0])

    assert header("none.jsonl")["tuning"] is None
    table = _save_table(fp, {"tile": 2, "split": 1})
    assert header("tuned.jsonl")["tuning"] == table.digest()
    monkeypatch.setenv("REPRO_NO_TUNING", "1")
    assert header("killed.jsonl")["tuning"] is None
    monkeypatch.delenv("REPRO_NO_TUNING")
    torch_fp = HardwareFingerprint("torch", "cpu", "float32")
    _save_table(torch_fp, {"tile": 2, "split": 1})
    assert AnomalyAtlas(tmp_path / "t.jsonl", torch_fp, "AATB",
                        0.10).program["tuning"] is None


def test_resume_under_another_tuning_table_is_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path / "profiles"))
    monkeypatch.delenv("REPRO_NO_TUNING", raising=False)
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    path = tmp_path / "atlas.jsonl"
    fp = _swept_atlas(path, [(32, 32, 32)])        # untuned
    AnomalyAtlas(path, fp, "AATB", 0.10)           # resumes untuned
    table = _save_table(fp, {"tile": 2, "split": 1})
    with pytest.raises(AtlasError, match=r"tuned by table None, this "
                                         r"process by '" + table.digest()):
        AnomalyAtlas(path, fp, "AATB", 0.10)
    monkeypatch.setenv("REPRO_NO_TUNING", "1")       # --no-tuning resumes
    AnomalyAtlas(path, fp, "AATB", 0.10)
    monkeypatch.delenv("REPRO_NO_TUNING")
    tuned = tmp_path / "tuned.jsonl"
    _swept_atlas(tuned, [(32, 32, 32)])
    _save_table(fp, {"tile": 1, "split": 1})         # another table
    with pytest.raises(AtlasError, match="tuned by table"):
        AnomalyAtlas(tuned, fp, "AATB", 0.10)


def test_atlas_without_the_tuning_key_is_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path / "profiles"))
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    path = tmp_path / "atlas.jsonl"
    fp = _swept_atlas(path, [(32, 32, 32)])
    lines = path.read_text().splitlines()
    header = json.loads(lines[0])
    assert "tuning" in header
    del header["tuning"]
    path.write_text("\n".join([json.dumps(header)] + lines[1:]) + "\n")
    with pytest.raises(AtlasError, match="start a fresh atlas"):
        AnomalyAtlas(path, fp, "AATB", 0.10)
    assert len(load_atlas_records(path).records) == 1   # the reference reads it


def test_atlas_merge_reads_tuned_headers_and_refuses_mixed_tuning(
        tmp_path, monkeypatch):
    """tools/atlas_merge.py is unchanged: shards whose headers carry the
    same ``tuning`` merge (the merged header keeps it), shards of two
    tuning states are refused by key."""
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path / "profiles"))
    monkeypatch.delenv("REPRO_NO_TUNING", raising=False)
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    merge = _atlas_merge()
    fp = HardwareFingerprint("cuda", "cpu", "float32")
    table = _save_table(fp, {"tile": 2, "split": 1})
    first, second = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    _swept_atlas(first, [(32, 32, 32)])
    _swept_atlas(second, [(64, 64, 64)])
    out = tmp_path / "merged.jsonl"
    assert merge.merge_shards([first, second], out).n_records == 2
    assert json.loads(out.read_text().splitlines()[0])["tuning"] == \
        table.digest()
    assert len(load_atlas_records(out).records) == 2
    monkeypatch.setenv("REPRO_NO_TUNING", "1")
    third = tmp_path / "c.jsonl"
    _swept_atlas(third, [(64, 64, 64)])
    with pytest.raises(merge.MergeError, match=r"\['tuning'\]"):
        merge.merge_shards([first, third])


def test_atlas_header_takes_the_runners_tuning(tmp_path, monkeypatch):
    """The header records the table the measuring runner launches under,
    not the cached file's: a runner pinned to another table, or to none,
    writes its own state, and resuming an atlas under a runner of another
    state is refused before anything is timed."""
    from repro_torch.core.tuning import TunedEntry, TuningTable
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path / "profiles"))
    monkeypatch.delenv("REPRO_NO_TUNING", raising=False)
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    spec = get_spec("aatb")
    fp = HardwareFingerprint("cuda", "cpu", "float32")
    cached = _save_table(fp, {"tile": 2, "split": 1})
    pinned = TuningTable()
    pinned.set("gemm", (32, 32, 32), TunedEntry(
        config={"tile": 1, "split": 1}, seconds=1.0, default_seconds=1.0,
        timed=1, pruned=0))
    assert pinned.digest() != cached.digest()

    def run(name, runner, points=((32, 32, 32),), opened_for=None):
        path = tmp_path / name
        atlas = AnomalyAtlas(path, fp, spec.name, 0.10, runner=opened_for)
        res = sweep(spec, list(points), runner=runner, atlas=atlas)
        return res, json.loads(path.read_text().splitlines()[0])["tuning"]

    assert run("auto.jsonl", CudaBackend(device="cpu", reps=1,
                                         seed=0))[1] == cached.digest()
    assert run("none.jsonl", CudaBackend(device="cpu", reps=1, seed=0,
                                         tuning=None))[1] is None
    runner = CudaBackend(device="cpu", reps=1, seed=0)
    runner.set_tuning(pinned)
    assert run("pinned.jsonl", runner)[1] == pinned.digest()
    assert AnomalyAtlas(tmp_path / "x.jsonl", fp, spec.name, 0.10,
                        runner=runner).program["tuning"] == pinned.digest()
    # Resumes: the pinned atlas opens for the pinned runner and resumes
    # under it; under the auto-loading runner it is refused, opened as
    # the cached table's or for the pinned runner alike.
    with pytest.raises(AtlasError, match="tuned by table"):
        AnomalyAtlas(tmp_path / "pinned.jsonl", fp, spec.name, 0.10)
    with pytest.raises(AtlasError, match="its runner launches under"):
        run("pinned.jsonl", CudaBackend(device="cpu", reps=1, seed=0),
            points=((64, 64, 64),), opened_for=runner)
    res, head = run("pinned.jsonl", runner, points=((64, 64, 64),),
                    opened_for=runner)
    assert res.n_measured == 1 and head == pinned.digest()
