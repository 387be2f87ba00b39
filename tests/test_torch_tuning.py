"""The port's launch tuner against the reference's, on the CPU.

Counterparts of tests/test_tuning.py. The pure parts (the tuning requests
of a calibration grid, the table's nearest-entry choice, persistence and
the kill-switch) are held against ``repro.core.tuning`` and
``repro.kernels.autotune`` on the same inputs; the port-side parts (the
kernels' own candidates as the search space, the shared-memory rule, the
cost-model order, ``config_from_dict``, ``tuning_override``, the graph
memo key, the measurement loop and ``calibrate --tune``) run on the
``cuda`` backend's plain versions. The reference's autotuner also probes
a Mosaic pipeline knob, which a Hopper launch does not have.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import calibrate as ref_calibrate
from repro.core import tuning as ref_tuning
from repro.kernels import autotune as ref_autotune
from repro_torch.core import calibrate
from repro_torch.core.backends import (CudaBackend, CudaOps, TorchBackend,
                                       synthetic_algorithm)
from repro_torch.core.backends import torch_backend
from repro_torch.core.fingerprint import HardwareFingerprint
from repro_torch.core.flops import KernelCall
from repro_torch.core.profile_store import (FingerprintMismatchError,
                                            SchemaVersionError,
                                            current_fingerprint)
from repro_torch.core.tuning import (KERNELS, TUNABLE_KINDS, CardLimits,
                                     TunedEntry, TuningTable,
                                     candidate_configs, default_config,
                                     launch_config, load_default_tuning_table,
                                     load_tuning_table, modeled_seconds,
                                     prune_candidates, save_tuning_table,
                                     smem_bytes, tuning_path)
from repro_torch.kernels import autotune
from repro_torch.kernels import chain_gemm as chain_mod
from repro_torch.kernels import gemm as gemm_mod
from repro_torch.kernels import gemm_syrk as gemm_syrk_mod
from repro_torch.kernels import syrk as syrk_mod

FP = HardwareFingerprint(backend="cuda", device="testdev", dtype="float32")

#: (kind, dims) requests at and around the sweep's shapes, ragged ones
#: and the calibration grid's extremes.
REQUESTS = [("gemm", (400, 800, 1200)), ("gemm", (32, 1024, 32)),
            ("gemm", (1024, 32, 1024)), ("gemm", (333, 517, 401)),
            ("syrk", (800, 400)), ("syrk", (32, 1024)), ("syrk", (1200, 96)),
            ("symm", (1200, 400)), ("symm", (32, 32)), ("symm", (517, 1024)),
            ("chain_gemm", (400, 800, 1200, 400)),
            ("chain_gemm", (64, 64, 64, 64)),
            ("gemm_syrk", (1200, 400, 800)), ("gemm_syrk", (64, 64, 64)),
            ("gemm_syrk", (1024, 1024, 1024))]


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path / "profiles"))
    monkeypatch.delenv("REPRO_NO_TUNING", raising=False)
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)


def _entry(config, seconds=1.0):
    return TunedEntry(config=dict(config), seconds=seconds,
                      default_seconds=seconds, timed=1, pruned=0)


# ------------------------------------------- pure parts vs the reference --

@pytest.mark.parametrize("grid", ["small", "default"])
def test_default_tune_requests_match_the_reference(grid):
    """Counterpart of the reference's ``default_tune_requests`` over
    ``grid_calls``: the same requests in the same order."""
    dims = calibrate.GRIDS[grid]
    assert dims == ref_calibrate.GRIDS[grid]
    mine = autotune.default_tune_requests(calibrate.grid_calls(dims),
                                          fused_dims=dims)
    theirs = ref_autotune.default_tune_requests(
        ref_calibrate.grid_calls(dims), fused_dims=dims)
    assert mine == theirs
    n = len(dims)
    assert len(mine) == n ** 3 + 2 * n ** 2 + 2 * n   # tri2full left out
    assert not any(kind == "tri2full" for kind, _ in mine)


@pytest.mark.parametrize("arity,seed", [(2, 0), (3, 1), (4, 2)])
def test_nearest_entry_choice_matches_the_reference(arity, seed):
    """``TuningTable.config`` falls back to the nearest same-kind entry in
    log-dim space exactly as ``repro.core.tuning.TuningTable.config``:
    the same chosen key for 300 seeded queries (exact hits included)."""
    rng = np.random.default_rng(seed)
    kind = {2: "syrk", 3: "gemm", 4: "chain_gemm"}[arity]
    keys = {tuple(int(d) for d in rng.integers(1, 1500, arity))
            for _ in range(40)}
    keys |= {(64,) * arity, (65,) * arity, (2,) * arity, (1,) * arity}
    mine, theirs = TuningTable(), ref_tuning.TuningTable()
    for i, dims in enumerate(sorted(keys)):
        mine.set(kind, dims, _entry({"id": i}))
        theirs.set(kind, dims, ref_tuning.TunedEntry(
            config={"id": i}, seconds=1.0, default_seconds=1.0, timed=1,
            pruned=0))
    mine.set("symm", (100, 100), _entry({"id": -1}))   # another kind
    theirs.set("symm", (100, 100), ref_tuning.TunedEntry(
        config={"id": -1}, seconds=1.0, default_seconds=1.0, timed=1,
        pruned=0))
    queries = [tuple(int(d) for d in rng.integers(1, 2500, arity))
               for _ in range(280)] + sorted(keys)[:20]
    for q in queries:
        assert mine.config(kind, q) == theirs.config(kind, q), q
    assert mine.config("gemm_syrk", (10, 10, 10)) is None


def test_tuning_table_round_trips(tmp_path):
    table = TuningTable()
    table.set("gemm", (256, 256, 256), TunedEntry(
        config={"tile": 1, "split": 2}, seconds=1e-4, default_seconds=2e-4,
        timed=5, pruned=7))
    table.set("chain_gemm", (128, 128, 128, 128), _entry({"piece": 2}, 3e-4))
    path = save_tuning_table(table, FP, directory=tmp_path,
                             meta={"grid": "test"})
    assert path == tuning_path(FP, tmp_path)
    assert path.name == "tuning-cuda-testdev-float32.json"
    loaded, fp = load_tuning_table(path, expected_fingerprint=FP)
    assert fp == FP and len(loaded) == 2
    entry = loaded.entry("gemm", (256, 256, 256))
    assert entry.config == {"tile": 1, "split": 2}
    assert (entry.seconds, entry.default_seconds) == (1e-4, 2e-4)
    assert (entry.timed, entry.pruned) == (5, 7)
    assert loaded.meta["grid"] == "test"
    assert loaded.entries == table.entries
    assert loaded.digest() == table.digest()
    # The reference reads the port's file: the same JSON layout.
    ref_loaded, _ = ref_tuning.load_tuning_table(path)
    assert ref_loaded.config("gemm", (256, 256, 256)) == {"tile": 1,
                                                           "split": 2}


def test_tuning_table_rejects_wrong_fingerprint(tmp_path):
    path = save_tuning_table(TuningTable(), FP, directory=tmp_path)
    other = HardwareFingerprint(backend="cuda", device="elsewhere",
                                dtype="float32")
    with pytest.raises(FingerprintMismatchError):
        load_tuning_table(path, expected_fingerprint=other)


def test_tuning_table_rejects_wrong_schema(tmp_path):
    path = save_tuning_table(TuningTable(), FP, directory=tmp_path)
    doc = json.loads(path.read_text())
    doc["version"] = 99
    path.write_text(json.dumps(doc))
    with pytest.raises(SchemaVersionError):
        load_tuning_table(path)


@pytest.mark.parametrize("text", ["{not json", '{"version": 1, "fingerprint"'
                                  ': {"backend": "cuda", "device": "cpu", '
                                  '"dtype": "float32"}, "entries": [{}]}'])
def test_corrupt_table_degrades_to_none(text):
    fp = current_fingerprint(backend="cuda", dtype="float32", device="cpu")
    path = tuning_path(fp)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    assert load_default_tuning_table(device="cpu") is None
    assert CudaBackend(device="cpu").tuning_table() is None


def test_kill_switch_disables_auto_load(monkeypatch):
    fp = current_fingerprint(backend="cuda", dtype="float32", device="cpu")
    table = TuningTable()
    table.set("gemm", (128, 128, 128), _entry({"tile": 2, "split": 1}))
    save_tuning_table(table, fp)
    assert load_default_tuning_table(device="cpu") is not None
    monkeypatch.setenv("REPRO_NO_TUNING", "1")
    assert load_default_tuning_table(device="cpu") is None
    # And dispatch-time lookup goes dark too, even with a table pinned.
    backend = CudaBackend(device="cpu", reps=1)
    backend.set_tuning(table)
    assert backend._config_lookup("gemm", (128, 128, 128)) is None


def test_backend_auto_loads_saved_table():
    fp = current_fingerprint(backend="cuda", dtype="float32", device="cpu")
    table = TuningTable()
    table.set("gemm", (256, 256, 256), _entry({"tile": 2, "split": 1}))
    save_tuning_table(table, fp)
    backend = CudaBackend(device="cpu", reps=1)
    assert backend.tuning_table().entries == table.entries
    assert backend._config_lookup("gemm", (256, 256, 256)) == {
        "tile": 2, "split": 1}
    cfg = backend.ops()._cfg("gemm", (256, 256, 256), torch.zeros(1))
    assert cfg == gemm_mod.with_split(2, 256, 1)
    # The torch backend has no launch to tune.
    assert not TorchBackend.supports_tuning and CudaBackend.supports_tuning


# ----------------------------------------------------- the search space --

@pytest.mark.parametrize("kind,dims", REQUESTS)
def test_candidate_configs_are_the_kernels_candidates(kind, dims):
    mod = KERNELS[kind]
    want = {"gemm": lambda: gemm_mod.candidates(dims[2]),
            "syrk": lambda: syrk_mod.syrk_candidates(dims[1]),
            "symm": lambda: gemm_mod.candidates(dims[0]),
            "chain_gemm": lambda: list(chain_mod.CONFIGS),
            "gemm_syrk": lambda: gemm_syrk_mod.candidates(dims[0])}[kind]()
    configs = candidate_configs(kind, dims)
    assert configs == [mod.config_to_dict(c) for c in want]
    # Each entry names exactly its launch.
    assert [launch_config(kind, dims, c) for c in configs] == want


def test_tri2full_is_not_tunable():
    assert "tri2full" not in TUNABLE_KINDS
    assert TUNABLE_KINDS == ref_tuning.TUNABLE_KINDS
    with pytest.raises(ValueError, match="not tunable"):
        candidate_configs("tri2full", (256,))


@pytest.mark.parametrize("kind,dims", REQUESTS)
@pytest.mark.parametrize("budget", [1, 3, 8])
def test_prune_keeps_the_model_pick_in_model_order_within_budget(
        kind, dims, budget):
    report = prune_candidates(kind, dims, budget=budget)
    pick = default_config(kind, dims)
    assert report.default == pick
    assert pick in report.survivors
    # The pick is the cheapest modeled launch, so it leads.
    assert report.survivors[0] == pick
    assert report.modeled == sorted(report.modeled)
    assert report.modeled == [modeled_seconds(kind, dims, c)
                              for c in report.survivors]
    assert len(report.survivors) <= budget
    everything = candidate_configs(kind, dims)
    assert len(report.survivors) + len(report.rejected) == len(everything)
    assert {r.reason for r in report.rejected} <= {"model", "budget"}
    best = report.modeled[0]
    for r in report.rejected:
        cost = modeled_seconds(kind, dims, r.config)
        assert cost >= report.modeled[-1] or cost > 2.0 * best


def test_smem_rule_rejects_none_of_the_compiled_launches():
    """The largest dynamic shared memory of a compiled launch outside
    gemm_syrk is the chain's 128x128 piece, 118,272 B (the GEMM routine's
    ring 50,688 B + the piece 67,584 B), under the H100's opt-in 232,448 B;
    gemm_syrk's candidates are by definition those that fit."""
    assert gemm_mod.tile_smem_bytes(128, 128) == 50688
    assert chain_mod.CONFIGS[0].smem_bytes == 118272
    assert CardLimits().smem_bytes == 232448
    most = {}
    for kind, dims in REQUESTS:
        for config in candidate_configs(kind, dims):
            most[kind] = max(most.get(kind, 0),
                             smem_bytes(kind, dims, config))
        report = prune_candidates(kind, dims, budget=100, slack=1e9)
        assert not report.rejected
    assert max(n for k, n in most.items() if k != "gemm_syrk") == 118272
    assert most["gemm_syrk"] <= 232448


def test_smem_rule_rejects_over_the_limit_before_timing():
    limits = CardLimits(smem_bytes=40000)
    report = prune_candidates("gemm", (400, 800, 1200), limits=limits,
                              budget=100, slack=1e9)
    smem = [r for r in report.rejected if r.reason == "smem"]
    assert smem and all(r.config["tile"] == 0 for r in smem)  # 128x128
    assert all(c["tile"] != 0 for c in report.survivors
               if c != report.default)


@pytest.mark.parametrize("kind,dims,good", [
    ("gemm", (400, 800, 1200), {"tile": 1, "split": 2}),
    ("syrk", (800, 400), {"tile": 2, "split": 3}),
    ("symm", (1200, 400), {"tile": 0, "split": 4}),
    ("chain_gemm", (400, 800, 1200, 400), {"piece": 2}),
    ("gemm_syrk", (1200, 400, 800), {"bl": 32, "cluster": 5}),
])
def test_config_from_dict_drops_what_no_launch_names(kind, dims, good):
    mod = KERNELS[kind]
    cfg = mod.config_from_dict(dims, good)
    assert cfg is not None and mod.config_to_dict(cfg) == good
    # Unknown keys are ignored; a reference entry names nothing here.
    assert mod.config_from_dict(dims, {**good, "pipeline": 1, "x": 7}) == cfg
    assert mod.config_from_dict(dims, {"bm": 128, "bn": 128, "bk": 128}) \
        is None
    assert mod.config_from_dict(dims, {}) is None
    assert mod.config_from_dict(dims, {k: "junk" for k in good}) is None
    key = next(iter(good))
    for value in (-1, 3, 99):   # a tile, piece or chunk outside the kernel's
        assert mod.config_from_dict(dims, {**good, key: value}) is None
    if kind == "gemm_syrk":
        assert mod.config_from_dict(dims, {**good, "cluster": 9}) is None
    if "split" in good:   # splits the contraction does not cut into
        assert mod.config_from_dict(dims, {**good, "split": 5}) is None
        shallow = {"gemm": (400, 800, 96), "syrk": (800, 96),
                   "symm": (96, 400)}[kind]
        assert mod.config_from_dict(shallow, good) is None
        assert mod.config_from_dict(shallow, {**good, "split": 1}) \
            is not None


def test_gemm_syrk_entries_follow_the_cards_clusters():
    dims, entry = (1200, 400, 800), {"bl": 32, "cluster": 8}
    assert gemm_syrk_mod.config_from_dict(dims, entry) is not None
    none_of_8 = gemm_syrk_mod.ACTIVE_CLUSTERS[:7] + (0,)
    assert gemm_syrk_mod.config_from_dict(dims, entry, none_of_8) is None
    assert launch_config("gemm_syrk", dims, entry,
                         CardLimits(active=none_of_8)) is None
    # A panel too tall for a cluster's shared memory: refused.
    assert gemm_syrk_mod.config_from_dict(
        (gemm_syrk_mod.max_m() + 64, 64, 64), {"bl": 64, "cluster": 1}) \
        is None


def test_a_foreign_entry_falls_back_to_the_model_pick(monkeypatch):
    """A table entry no launch names (here the reference's own layout) is
    dropped: the kernel is called with ``config=None``, so its wrapper's
    launch rule — the hand kernel's model pick on a card — runs."""
    seen = []

    def spy(a, b, config=None):
        seen.append(config)
        return a @ b

    monkeypatch.setattr(torch_backend.kops, "gemm", spy)
    a, b = torch.ones(40, 30), torch.ones(30, 20)
    foreign = CudaOps(lambda kind, dims: {"bm": 256, "bn": 256, "bk": 128})
    foreign.gemm(a, b)
    good = CudaOps(lambda kind, dims: {"tile": 2, "split": 1})
    good.gemm(a, b)
    assert seen == [None, gemm_mod.with_split(2, 30, 1)]


def test_tuning_override_wins_over_table_and_kill_switch(monkeypatch):
    dims = (256, 256, 256)
    table = TuningTable()
    table.set("gemm", dims, _entry({"tile": 2, "split": 1}))
    backend = CudaBackend(device="cpu", reps=1, tuning=table)
    assert backend._config_lookup("gemm", dims) == {"tile": 2, "split": 1}
    monkeypatch.setenv("REPRO_NO_TUNING", "1")
    assert backend._config_lookup("gemm", dims) is None
    gen = backend._tuning_generation
    with backend.tuning_override({("gemm", dims): {"tile": 1, "split": 2}}):
        assert backend._config_lookup("gemm", dims) == {"tile": 1,
                                                         "split": 2}
        assert backend._config_lookup("gemm", (128, 128, 128)) is None
        assert backend._tuning_generation == gen + 1
    assert backend._tuning_generation == gen + 2
    assert backend._config_lookup("gemm", dims) is None
    monkeypatch.delenv("REPRO_NO_TUNING")
    assert backend._config_lookup("gemm", dims) == {"tile": 2, "split": 1}


def test_graph_memo_key_follows_the_tuning_state(monkeypatch):
    """With the capture stubbed: two candidates at the same pointers and
    dims get two memo entries, the same candidate looked up twice one;
    the kill-switch and ``set_tuning`` change the key too."""
    backend = CudaBackend(device="cpu", reps=1, tuning=None)
    captures = []

    def fake_capture(alg, operands):
        captures.append(backend._memo_generation())
        return torch_backend.CapturedWalk(graph=None, out=torch.zeros(1),
                                          launches={}, nbytes=0)

    monkeypatch.setattr(backend, "_capture", fake_capture)
    dims = (64, 48, 32)
    alg = synthetic_algorithm(KernelCall("gemm", dims))
    operands = backend.make_operands(alg)
    first, second = candidate_configs("gemm", dims)[:2]
    for entry in (first, second):
        with backend.tuning_override({("gemm", dims): entry}):
            backend._graph(alg, operands)
            backend._graph(alg, operands)        # the same candidate: a hit
    assert len(captures) == 2 and len(backend._graphs) == 2
    assert (backend.memo_hits, backend.memo_misses) == (2, 2)
    backend._graph(alg, operands)                # neither candidate
    monkeypatch.setenv("REPRO_NO_TUNING", "1")
    backend._graph(alg, operands)
    monkeypatch.delenv("REPRO_NO_TUNING")
    backend.set_tuning(TuningTable())
    backend._graph(alg, operands)
    assert len(captures) == 5 and len(set(captures)) == 5


# ------------------------------------------------------- the autotuner --

def test_autotune_request_picks_measured_winner_and_counts():
    """Counterpart of the reference's spy-backend test: every survivor
    and nothing else reaches the timer, under its own override; the
    winner is the fastest measured; ``default_seconds`` is the model
    pick's time."""
    kind, dims = "gemm", (400, 800, 1200)
    report = prune_candidates(kind, dims)
    winner = report.survivors[-1]
    timed = []

    class SpyBackend(CudaBackend):
        def make_operands(self, alg):
            return {}

        def time_algorithm(self, alg, operands=None, reps=None):
            cfg = self._config_lookup(kind, dims)
            timed.append(cfg)
            return 0.25 if cfg == winner else 1.0

    entry = autotune.autotune_request(SpyBackend(device="cpu", reps=1),
                                      kind, dims)
    assert timed == report.survivors
    assert entry.config == winner and entry.seconds == 0.25
    assert entry.default_seconds == 1.0
    assert entry.timed == len(report.survivors)
    assert entry.pruned == len(report.rejected)


@pytest.mark.parametrize("kind,dims", [("gemm", (48, 40, 64)),
                                       ("syrk", (48, 64)),
                                       ("symm", (48, 40)),
                                       ("chain_gemm", (48, 40, 32, 24)),
                                       ("gemm_syrk", (48, 40, 32))])
def test_autotune_real_backend_tiny_request(kind, dims):
    """Counterpart of the reference's red test of the same name (its
    pipeline probe raises): on the CPU ``cuda`` backend the plain versions
    run, and the entry is counted as the pre-filter decided."""
    backend = CudaBackend(device="cpu", reps=1, seed=0)
    report = prune_candidates(kind, dims, budget=4)
    entry = autotune.autotune_request(backend, kind, dims, budget=4)
    assert entry.timed == len(report.survivors) <= 4
    assert entry.pruned == len(report.rejected)
    assert entry.config in report.survivors
    assert 0 < entry.seconds <= entry.default_seconds


def test_autotune_builds_a_table_with_progress():
    backend = CudaBackend(device="cpu", reps=1, seed=0)
    requests = [("gemm", (32, 32, 32)), ("chain_gemm", (32, 32, 32, 32))]
    seen = []
    table = autotune.autotune(backend, requests, budget=2,
                              progress=lambda *a: seen.append(a[:4]))
    assert sorted(table.entries) == sorted(requests)
    assert seen == [(1, 2) + requests[0], (2, 2) + requests[1]]


def test_calibrate_tune_cli_persists_and_backend_autoloads(capsys):
    """Counterpart of the reference's red test of the same name."""
    assert calibrate.main(["--tune", "--backend", "cuda", "--device", "cpu",
                           "--grid", "tiny", "--reps", "1", "--tune-budget",
                           "2", "--seed", "0", "--quiet"]) == 0
    out = capsys.readouterr().out
    assert "tuned 20 kernel shapes on cuda/cpu/float32" in out
    fp = current_fingerprint(backend="cuda", dtype="float32", device="cpu")
    path = tuning_path(fp)
    assert f"tuning table written to {path}" in out
    table, _ = load_tuning_table(path, expected_fingerprint=fp)
    assert len(table) == 20
    assert all(e.timed <= 2 for e in table.entries.values())
    assert json.loads(path.read_text())["meta"]["budget"] == 2
    fresh = CudaBackend(device="cpu")
    assert fresh.tuning_table().entries == table.entries
    key = ("gemm", (64, 128, 64))
    assert fresh._config_lookup(*key) == table.entries[key].config


def test_calibrate_tune_rejects_expr_and_untunable_backends(capsys):
    with pytest.raises(SystemExit) as exc:
        calibrate.main(["--tune", "--expr", "aatb", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--tune and --expr are mutually exclusive" in \
        capsys.readouterr().err
    with pytest.raises(ValueError, match="no tunable kernel parameters"):
        calibrate.tune(backend="torch", device="cpu", grid="tiny")
    with pytest.raises(ValueError, match="unknown grid"):
        calibrate.tune(device="cpu", grid="nope")


def test_dispatch_serves_exact_entries_only(monkeypatch):
    """The table keeps the reference's nearest-entry ``config``, but the
    ``cuda`` backend launches only exact entries: unseen dims keep the
    wrapper's launch rule (``config=None``)."""
    table = TuningTable()
    table.set("gemm", (256, 256, 256), _entry({"tile": 2, "split": 1}))
    table.set("chain_gemm", (64, 64, 64, 64), _entry({"piece": 0}))
    backend = CudaBackend(device="cpu", reps=1, tuning=table)
    near = (250, 256, 256)
    assert table.config("gemm", near) == {"tile": 2, "split": 1}
    assert backend._config_lookup("gemm", near) is None
    assert backend._config_lookup("chain_gemm", (64, 64, 64, 65)) is None
    assert backend._config_lookup("chain_gemm", (64, 64, 64, 64)) == {
        "piece": 0}
    seen = []

    def spy(a, b, config=None):
        seen.append(config)
        return a @ b

    monkeypatch.setattr(torch_backend.kops, "gemm", spy)
    ops = backend.ops()
    ops.gemm(torch.ones(250, 256), torch.ones(256, 256))
    ops.gemm(torch.ones(256, 256), torch.ones(256, 256))
    assert seen == [None, gemm_mod.with_split(2, 256, 1)]


def test_runner_tuning_is_the_runners_effective_table(monkeypatch):
    """What an atlas header records for a runner: its resolved table's
    digest; None for a pinned ``tuning=None``, under the kill-switch and
    on the untunable ``torch`` backend."""
    from repro_torch.core.tuning import runner_tuning
    fp = current_fingerprint(backend="cuda", dtype="float32", device="cpu")
    cached = TuningTable()
    cached.set("gemm", (128, 128, 128), _entry({"tile": 2, "split": 1}))
    save_tuning_table(cached, fp)
    pinned = TuningTable()
    pinned.set("gemm", (128, 128, 128), _entry({"tile": 1, "split": 1}))
    assert runner_tuning(CudaBackend(device="cpu")) == cached.digest()
    assert runner_tuning(CudaBackend(device="cpu", tuning=pinned)) == \
        pinned.digest()
    assert runner_tuning(CudaBackend(device="cpu", tuning=None)) is None
    assert runner_tuning(TorchBackend(device="cpu")) is None
    monkeypatch.setenv("REPRO_NO_TUNING", "1")
    assert runner_tuning(CudaBackend(device="cpu", tuning=pinned)) is None


def test_symm_entries_do_not_leak_into_gemm_lookups():
    """symm shares gemm's launch model, not its table entries: a tuned
    ``("symm", (m, n))`` answers no gemm lookup, and the model's pick of
    gemm at (m, n, m) stays untouched."""
    table = TuningTable()
    table.set("symm", (400, 1200), _entry({"tile": 2, "split": 1}))
    backend = CudaBackend(device="cpu", tuning=table)
    assert backend._config_lookup("gemm", (400, 1200, 400)) is None
    assert backend._config_lookup("symm", (400, 1200)) == {"tile": 2,
                                                            "split": 1}
    assert gemm_mod.gemm_config(400, 1200, 400) == \
        gemm_mod.gemm_config.__wrapped__(400, 1200, 400)
