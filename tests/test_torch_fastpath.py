"""The port's measurement fast path against the JAX package's, on the CPU.

The operand arena, the pipelined serial sweep, the worker pools and the
kill-switch of ``repro_torch.core.sweep`` / ``repro_torch.core.arena``
are held to the contract of the reference's ``tests/test_fastpath.py``:
the fast path and ``--no-fastpath`` write byte-identical atlases, a
killed fast-path sweep resumes to the same atlas, and the framework-
neutral pieces (locality order, structural keys, the counter block)
equal the reference's. Seeded numpy drives both packages; the runners
here report deterministic times, so records compare exactly.
"""

import functools
import gc
import threading
import weakref

import numpy as np
import pytest

from repro.core import arena as ref_arena
from repro.core import sweep as ref_sweep
from repro.core import synthetic as ref_synthetic
from repro.core.expressions import get_spec as ref_get_spec
from repro_torch.core import sweep as port_sweep
from repro_torch.core import synthetic as port_synthetic
from repro_torch.core.arena import (FastPathStats, OperandArena, PlacedArena,
                                    algorithm_structural_key, arena_for,
                                    order_points_for_locality)
from repro_torch.core.backends import CudaBackend, TorchBackend
from repro_torch.core.expressions import GridSpec, get_spec
from repro_torch.core.fingerprint import HardwareFingerprint
from repro_torch.core.flops import gemm, syrk
from repro_torch.core.sweep import (FASTPATH_ENV, AnomalyAtlas,
                                    benchmark_unique_calls, fastpath_enabled,
                                    measure_instance, sweep)
from test_torch_gpu import watched_fastpath_sweep

FP = HardwareFingerprint("cuda", "cpu", "float32")
GRID = GridSpec.uniform((32, 64, 96), 3, name="test")
PLANTED = GridSpec.uniform(tuple(range(10, 110, 10)), 2, name="planted")


class CliffRunner:
    """Deterministic FLOP-proportional timer with a SYRK cliff at m >= 64
    (the reference test's): a pure function of the algorithm."""

    def make_operands(self, alg):
        return {}

    def time_algorithm(self, alg, operands=None):
        t = 0.0
        for call in alg.calls:
            t += call.flops * 1e-9
            if call.kind == "syrk" and call.dims[0] >= 64:
                t += call.flops * 3e-9
        return t


class SeededFakeTime(CudaBackend):
    """Real seeded operands on the CPU through the arena, deterministic
    reported time, so the parity check also covers operand plumbing."""

    def time_algorithm(self, alg, operands=None, reps=None):
        assert operands, f"operands never reached the runner for {alg.name}"
        skew = 1.5 if any(c.kind == "syrk" for c in alg.calls) else 1.0
        return 1e-12 * alg.flops * skew


def _fake(seed=11):
    return SeededFakeTime(device="cpu", reps=1, seed=seed)


def _sweep_bytes(tmp_path, tag, spec, points, runner, fast, module=port_sweep,
                 fp=FP):
    path = tmp_path / f"{tag}.jsonl"
    atlas = module.AnomalyAtlas(path, fp, spec.name, 0.10)
    res = module.sweep(spec, points, runner=runner, atlas=atlas,
                       fastpath=fast)
    atlas.flush()
    return res, path.read_bytes()


def _rows(res):
    return [(r.point, r.times, r.flops, r.cls.is_anomaly, r.cls.cheapest,
             r.cls.fastest, r.cls.time_score) for r in res.records]


# ------------------------------------------------------------------ parity --

@pytest.mark.parametrize("mask", sorted(port_synthetic.planted_masks(PLANTED)))
def test_fastpath_matches_legacy_and_the_reference_on_planted_masks(tmp_path,
                                                                    mask):
    spec = port_synthetic.PlantedSpec()
    runner = port_synthetic.MaskRunner(
        port_synthetic.planted_masks(PLANTED)[mask])
    fast, fast_b = _sweep_bytes(tmp_path, "fast", spec, PLANTED.points(),
                                runner, True)
    legacy, legacy_b = _sweep_bytes(tmp_path, "legacy", spec,
                                    PLANTED.points(), runner, False)
    assert fast_b == legacy_b                       # atlas parity, bytewise
    assert fast.fastpath is not None and legacy.fastpath is None
    ref_spec = ref_synthetic.PlantedSpec()
    ref_runner = ref_synthetic.MaskRunner(
        ref_synthetic.planted_masks(PLANTED)[mask])
    ref_fp = ref_sweep.HardwareFingerprint("blas", "testdev", "float64")
    ref, _ = _sweep_bytes(tmp_path, "ref", ref_spec, PLANTED.points(),
                          ref_runner, True, ref_sweep, ref_fp)
    assert _rows(fast) == _rows(ref)


def test_fastpath_matches_legacy_with_real_operands(tmp_path):
    pts = GRID.points()
    fast, fast_b = _sweep_bytes(tmp_path, "fast", get_spec("aatb"), pts,
                                _fake(), True)
    legacy, legacy_b = _sweep_bytes(tmp_path, "legacy", get_spec("aatb"), pts,
                                    _fake(), False)
    assert fast_b == legacy_b
    st = fast.fastpath
    assert st.arena_hits > 0 and st.points_pipelined == len(pts) - 1
    assert 0.0 <= st.overlap_fraction <= 1.0
    # The reference's fast path on the same operands and times.
    ref = ref_sweep.sweep(ref_get_spec("aatb"), pts,
                          runner=CliffRunner(), fastpath=True)
    port = sweep(get_spec("aatb"), pts, runner=CliffRunner(), fastpath=True)
    assert _rows(port) == _rows(ref)


def test_fastpath_preserves_requested_order_and_budget():
    pts = list(reversed(GRID.points()))
    res = sweep(get_spec("aatb"), pts, runner=CliffRunner(), fastpath=True)
    assert [r.point for r in res.records] == pts
    capped = sweep(get_spec("aatb"), pts, runner=CliffRunner(),
                   max_instances=5, fastpath=True)
    assert [r.point for r in capped.records] == pts[:5]


def test_direct_measure_instance_with_arena_matches_legacy():
    runner = _fake(3)
    arena = arena_for(runner)
    for p in GRID.points()[:4]:
        via_arena = measure_instance(get_spec("aatb"), p, runner, 0.10,
                                     arena=arena)
        assert via_arena == measure_instance(get_spec("aatb"), p, runner,
                                             0.10)


def test_killed_fastpath_sweep_resumes_to_the_legacy_atlas(tmp_path):
    """Kill after 10 points, resume with a fresh runner (fresh arena): the
    stitched atlas is byte-identical to an uninterrupted legacy sweep."""
    spec = get_spec("aatb")
    path = tmp_path / "fast.jsonl"
    first = sweep(spec, GRID.points(), runner=_fake(),
                  atlas=AnomalyAtlas(path, FP, spec.name, 0.10, chunk_size=5),
                  max_instances=10, fastpath=True)
    assert first.n_measured == 10
    again = sweep(spec, GRID.points(), runner=_fake(),
                  atlas=AnomalyAtlas(path, FP, spec.name, 0.10),
                  fastpath=True)
    assert (again.n_skipped, again.n_measured) == (10, GRID.n_points - 10)
    _, legacy_b = _sweep_bytes(tmp_path, "legacy", spec, GRID.points(),
                               _fake(), False)
    assert path.read_bytes() == legacy_b


# ------------------------------------------------------------- kill-switch --

@pytest.mark.parametrize("module", [port_sweep, ref_sweep],
                         ids=["port", "reference"])
def test_fastpath_enabled_flag_and_env(monkeypatch, module):
    monkeypatch.delenv(module.FASTPATH_ENV, raising=False)
    assert module.fastpath_enabled() is True
    assert module.fastpath_enabled(False) is False
    monkeypatch.setenv(module.FASTPATH_ENV, "1")
    assert module.fastpath_enabled() is False
    assert module.fastpath_enabled(True) is True     # explicit flag wins
    spec = (get_spec if module is port_sweep else ref_get_spec)("aatb")
    res = module.sweep(spec, GRID.points()[:2], runner=CliffRunner())
    assert res.fastpath is None                      # env took the legacy path


def test_cli_no_fastpath_flag(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(FASTPATH_ENV, "")             # registered for teardown
    base = ["--expr", "aatb", "--grid", "smoke", "--reps", "1", "--seed",
            "0", "--device", "cpu", "--no-flush", "--quiet"]
    assert port_sweep.main(base + ["--atlas-dir", str(tmp_path / "a"),
                                   "--no-fastpath"]) == 0
    out = capsys.readouterr().out
    assert "fastpath:" not in out and "measured=8" in out
    assert fastpath_enabled() is False               # workers inherit it
    monkeypatch.setenv(FASTPATH_ENV, "")
    assert port_sweep.main(base + ["--atlas-dir", str(tmp_path / "b")]) == 0
    out = capsys.readouterr().out
    assert "fastpath: arena" in out and "pipelined 7" in out
    # Same seeded operands, so the same points and algorithms; times differ.
    a, b = (sorted((r.point, sorted(r.times)) for r in AnomalyAtlas(
        next((tmp_path / d).glob("*.jsonl")), FP, "AATB", 0.10).records())
        for d in "ab")
    assert a == b


# ------------------------------------------------------------ operand arena --

def test_placed_arena_serves_the_runners_bits_and_one_buffer_per_leaf():
    algos = get_spec("aatb").algorithms((32, 48, 64))
    runner = CudaBackend(device="cpu", reps=1, seed=5)
    arena = arena_for(runner)
    assert isinstance(arena, PlacedArena) and arena_for(runner) is arena
    pooled = arena.operands(algos)
    legacy = runner.make_operands(algos[0])
    for base, buf in legacy.items():
        assert buf.dtype == pooled[base].dtype
        assert bool((buf == pooled[base]).all())
    hits0, misses0, nbytes = arena.snapshot()
    assert nbytes == sum(t.numel() * 4 for t in pooled.values())
    again = arena.operands(algos)
    assert all(again[k] is pooled[k] for k in pooled)
    assert arena.snapshot()[:2] == (hits0 + len(pooled), misses0)
    # The reference's arena draws the same bits for the same seed.
    ref_runner = ref_sweep.make_backend("numpy", reps=1, flush_cache=False,
                                        seed=5)
    ref_ops = ref_arena.OperandArena(ref_runner).operands(
        ref_get_spec("aatb").algorithms((32, 48, 64)))
    for base, arr in ref_ops.items():
        np.testing.assert_array_equal(pooled[base].numpy(),
                                      np.asarray(arr, dtype=np.float32))


def test_duck_typed_runners_get_the_single_stage_arena():
    spec = port_synthetic.PlantedSpec()
    runner = port_synthetic.MaskRunner(
        port_synthetic.planted_masks(PLANTED)["full"])
    arena = arena_for(runner)
    assert type(arena) is OperandArena
    assert arena.place(arena.stage(spec.algorithms((10, 20)))) == {}


def test_a_released_runner_releases_its_arena():
    """The reference's arena holds its runner strongly as the value of a
    weak-keyed registry, so neither is ever freed; the port's holds it
    weakly (on a card the runner also holds its captured graphs)."""
    runner = TorchBackend(device="cpu", reps=1, seed=1)
    arena_for(runner).operands(get_spec("aatb").algorithms((32, 32, 32)))
    gone = weakref.ref(runner)
    del runner
    gc.collect()
    assert gone() is None


def test_pipelined_fast_path_places_operands_only_between_repetitions():
    watched_fastpath_sweep(CudaBackend(device="cpu", seed=0, reps=1))


def test_helper_thread_touches_no_device():
    """Stage one runs on the helper: host numpy only."""
    runner = CudaBackend(device="cpu", reps=1, seed=2)
    arena = arena_for(runner)
    staged = {}
    t = threading.Thread(target=lambda: staged.update(arena.stage(
        get_spec("abab").algorithms((32, 48, 64)))))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert staged and all(isinstance(a, np.ndarray) and a.dtype == np.float32
                          for a in staged.values())


# -------------------------------------------------- structural keys / order --

@pytest.mark.parametrize("name,point", [("aatb", (32, 48, 64)),
                                        ("abcd", (32, 48, 64, 80, 96)),
                                        ("abab", (32, 48, 64))])
def test_structural_keys_equal_the_references(name, point):
    port = [algorithm_structural_key(a)
            for a in get_spec(name).algorithms(point)]
    ref = [ref_arena.algorithm_structural_key(a)
           for a in ref_get_spec(name).algorithms(point)]
    assert port == ref
    assert len(set(port)) == len(port)               # no memo collisions


def test_order_points_for_locality_equals_the_references():
    rng = np.random.default_rng(0)
    pts = [tuple(int(x) for x in rng.integers(1, 9, 3)) for _ in range(40)]
    assert order_points_for_locality(pts) == \
        ref_arena.order_points_for_locality(pts) == sorted(pts)


def test_fastpath_stats_round_trip_equals_the_references():
    a = FastPathStats(arena_hits=2, arena_misses=1, prep_s=0.5,
                      overlap_s=0.25, points_pipelined=3)
    r = ref_arena.FastPathStats(arena_hits=2, arena_misses=1, prep_s=0.5,
                                overlap_s=0.25, points_pipelined=3)
    assert a.as_dict() == r.as_dict() and a.summary() == r.summary()
    assert FastPathStats.from_dict(r.as_dict()) == a
    a.merge(FastPathStats(arena_hits=1, memo_hits=4))
    r.merge(ref_arena.FastPathStats(arena_hits=1, memo_hits=4))
    assert a.as_dict() == r.as_dict() and a.overlap_fraction == 0.5


def test_benchmark_unique_calls_with_arena_counts_reuse():
    runner = _fake(9)
    arena = arena_for(runner)
    stats = FastPathStats()
    calls = [gemm(32, 32, 32), syrk(32, 32), gemm(32, 32, 32),
             gemm(32, 48, 32)]
    profile, n_meas, n_reused = benchmark_unique_calls(
        runner, calls, arena=arena, stats=stats)
    assert (n_meas, n_reused) == (3, 0) and all(c in profile for c in calls)
    misses = arena.snapshot()[1]
    assert misses > 0 and stats.arena_misses == misses
    _, n2, r2 = benchmark_unique_calls(runner, calls, profile=profile,
                                       arena=arena, stats=stats)
    assert (n2, r2) == (0, 3) and arena.snapshot()[1] == misses


# ------------------------------------------------------------ worker pools --

def test_process_pool_measures_what_the_serial_path_does(tmp_path):
    """Spawned workers (a forked child could not use CUDA) each build their
    runner from a picklable factory; chunks stream back in any order."""
    spec = port_synthetic.PlantedSpec()
    mask = port_synthetic.planted_masks(PLANTED)["multi"]
    serial = sweep(spec, PLANTED.points(),
                   runner=port_synthetic.MaskRunner(mask))
    pooled = sweep(spec, PLANTED.points(), backend="process", shards=2,
                   runner_factory=functools.partial(
                       port_synthetic.MaskRunner, mask), chunk_size=25)
    assert _rows(pooled) == _rows(serial)
    assert pooled.fastpath.arena_hits == pooled.fastpath.arena_misses == 0


def test_one_worker_process_per_device(tmp_path):
    """``_run_devices`` over two devices (two CPU processes here, two cards
    on a host that has them): every point once, on real operands."""
    spec = get_spec("aatb")
    got, stats = [], FastPathStats()
    port_sweep._run_devices(spec, GRID.points(), 0.10, 1, "cuda", "float32",
                            ["cpu", "cpu"], got.append, seed=0,
                            chunk_size=5, stats=stats)
    assert sorted(r.point for r in got) == sorted(GRID.points())
    names = [a.name for a in spec.algorithms((32, 32, 32))]
    assert all(sorted(r.times) == sorted(names) for r in got)
    assert stats.arena_misses > 0


def test_sweep_refuses_a_runner_for_the_pools():
    with pytest.raises(ValueError, match="runner= only configures"):
        sweep(get_spec("aatb"), GRID.points(), runner=CliffRunner(),
              backend="devices")
    with pytest.raises(ValueError, match="serial|process|devices"):
        sweep(get_spec("aatb"), GRID.points(), runner_factory=CliffRunner,
              backend="jax")
