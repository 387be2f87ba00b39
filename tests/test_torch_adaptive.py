"""The port's adaptive sweep and shard fan-out against the JAX package's,
on the CPU.

``repro_torch.core.adaptive`` and ``repro_torch.core.synthetic`` are the
port's copies of the reference's modules, measuring through the port's
sweep engine and atlas. On the reference's planted masks (ground truth
by construction, ``repro.core.synthetic``) both packages must admit the
same points in every round and reach the same frontier; a killed run
resumes to the uninterrupted one's measured set; shard files merged by
``tools/atlas_merge.py`` equal the unsharded atlas point for point. The
CLI runs end to end on the ``cuda`` backend's plain versions
(``--device cpu``).
"""

import functools
import importlib.util
import json
import os
import pathlib
import sys

import numpy as np
import pytest

from repro.core import adaptive as ref_adaptive
from repro.core import synthetic as ref_synthetic
from repro.core.evaluate import load_atlas_records
from repro.core.sweep import main as ref_main
from repro_torch.core import adaptive as port_adaptive
from repro_torch.core import synthetic as port_synthetic
from repro_torch.core.expressions import GridSpec
from repro_torch.core.fingerprint import HardwareFingerprint
from repro_torch.core.sweep import (AnomalyAtlas, AtlasError,
                                    atlas_shard_path, main as port_main)

REPO = pathlib.Path(__file__).resolve().parent.parent
FP = HardwareFingerprint("cuda", "cpu", "float32")
SPEC = port_synthetic.PlantedSpec()
REF_SPEC = ref_synthetic.PlantedSpec()
# The reference test's 20x20 grid and its 40 % budget.
GRID = GridSpec.uniform(tuple(range(10, 210, 10)), 2, name="planted20")
BUDGET = int(0.40 * GRID.n_points)
MASKS = sorted(port_synthetic.planted_masks(GRID))


def _merge_mod():
    if "atlas_merge" in sys.modules:
        return sys.modules["atlas_merge"]
    spec = importlib.util.spec_from_file_location(
        "atlas_merge", REPO / "tools" / "atlas_merge.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["atlas_merge"] = mod   # its dataclasses look the module up
    spec.loader.exec_module(mod)
    return mod


def _pair(name):
    """The planted mask ``name`` as a (port, reference) runner pair."""
    return (port_synthetic.MaskRunner(port_synthetic.planted_masks(GRID)[name]),
            ref_synthetic.MaskRunner(ref_synthetic.planted_masks(GRID)[name]))


class KillingRunner:
    """MaskRunner that dies after ``fail_after`` timings (kill mid-round)."""

    def __init__(self, mask, fail_after):
        self.inner = port_synthetic.MaskRunner(mask)
        self.fail_after = fail_after
        self.count = 0

    def make_operands(self, alg):
        return {}

    def time_algorithm(self, alg, operands=None):
        self.count += 1
        if self.count > self.fail_after:
            raise RuntimeError("simulated kill")
        return self.inner.time_algorithm(alg, operands)


# ---------------------------------------------------- parity per planted mask --

@pytest.mark.parametrize("name", MASKS)
def test_admitted_points_per_round_and_frontier_equal_the_references(name):
    port_runner, ref_runner = _pair(name)
    port = port_adaptive.adaptive_sweep(SPEC, GRID, BUDGET,
                                        runner=port_runner)
    ref = ref_adaptive.adaptive_sweep(REF_SPEC, GRID, BUDGET,
                                      runner=ref_runner)
    assert [r.admitted for r in port.rounds] == \
        [r.admitted for r in ref.rounds]
    assert (port.spent, port.stopped) == (ref.spent, ref.stopped)
    assert port.verdicts() == ref.verdicts()
    assert port.frontier() == ref.frontier()
    assert [(r.lo, r.hi) for r in port.regions()] == \
        [(r.lo, r.hi) for r in ref.regions()]
    # And the contract the reference's tests pin: >= 0.9 frontier recall
    # at <= 40 % of the dense count, every verdict the planted truth.
    oracle = port_synthetic.dense_oracle(port_runner.mask, GRID)
    assert all(v == oracle[p] for p, v in port.verdicts().items())
    assert port_synthetic.frontier_recall(
        port.known, port_synthetic.true_frontier(port_runner.mask,
                                                 GRID)) >= 0.9


@pytest.mark.parametrize("stride", [1, 2, 3, 4, 7])
def test_seed_points_and_refinement_equal_the_references(stride):
    axes = (tuple(range(0, 70, 7)), tuple(range(100, 124, 2)))
    grid = GridSpec(name="g", axes=axes)
    assert port_adaptive.seed_points(grid, stride) == \
        ref_adaptive.seed_points(grid, stride)
    rng = np.random.default_rng(stride)
    verdicts = {p: bool(rng.integers(2))
                for p in port_adaptive.seed_points(grid, stride)}
    for _ in range(6):
        cands = port_adaptive.refinement_candidates(verdicts, grid)
        assert cands == ref_adaptive.refinement_candidates(verdicts, grid)
        assert port_adaptive.boundary_cells(verdicts, grid) == \
            ref_adaptive.boundary_cells(verdicts, grid)
        verdicts.update({c: bool(rng.integers(2)) for c in cands})


@pytest.mark.parametrize("module", [port_adaptive, ref_adaptive],
                         ids=["port", "reference"])
def test_adaptive_validation_errors(tmp_path, module):
    r = port_synthetic.MaskRunner(port_synthetic.EmptyMask())
    spec = SPEC if module is port_adaptive else REF_SPEC
    with pytest.raises(ValueError, match="budget"):
        module.adaptive_sweep(spec, GRID, 0, runner=r)
    with pytest.raises(ValueError, match="rounds"):
        module.adaptive_sweep(spec, GRID, 5, rounds=-1, runner=r)
    with pytest.raises(ValueError, match="stride"):
        module.adaptive_sweep(spec, GRID, 5, seed_stride=0, runner=r)
    with pytest.raises(ValueError, match="grid has 3 axes"):
        module.adaptive_sweep(spec, GridSpec.uniform((10, 20), 3), 5,
                              runner=r)
    with pytest.raises(ValueError, match="0 <= k < n"):
        module.adaptive_sweep(spec, GRID, 5, shard=(2, 2), runner=r)
    with pytest.raises(ValueError, match="shard mode needs"):
        module.adaptive_sweep(spec, GRID, 5, shard=(0, 2), runner=r)


# ------------------------------------------------------------- kill/resume --

@pytest.mark.parametrize("fail_after", (7, 91, 200))
def test_kill_resume_converges_to_the_same_measured_set(tmp_path,
                                                        fail_after):
    port_runner, ref_runner = _pair("blob")
    ref = ref_adaptive.adaptive_sweep(REF_SPEC, GRID, BUDGET,
                                      runner=ref_runner)
    path = tmp_path / "killed.jsonl"
    with pytest.raises(RuntimeError, match="simulated kill"):
        port_adaptive.adaptive_sweep(
            SPEC, GRID, BUDGET, runner=KillingRunner(port_runner.mask,
                                                     fail_after),
            atlas=AnomalyAtlas(path, FP, SPEC.name, 0.10, chunk_size=4))
    survivors = {r.point
                 for r in AnomalyAtlas(path, FP, SPEC.name, 0.10).records()}
    assert survivors < set(ref.known)
    res = port_adaptive.adaptive_sweep(
        SPEC, GRID, BUDGET, runner=port_runner,
        atlas=AnomalyAtlas(path, FP, SPEC.name, 0.10))
    assert res.verdicts() == ref.verdicts()
    assert (res.spent, res.stopped) == (ref.spent, ref.stopped)
    assert res.n_measured == len(ref.known) - len(survivors)


def test_resumed_run_honors_the_remaining_budget(tmp_path):
    port_runner, _ = _pair("blob")
    full = port_adaptive.adaptive_sweep(SPEC, GRID, BUDGET,
                                        runner=port_runner)
    path = tmp_path / "resume.jsonl"
    first = port_adaptive.adaptive_sweep(
        SPEC, GRID, BUDGET, rounds=1, runner=port_runner,
        atlas=AnomalyAtlas(path, FP, SPEC.name, 0.10))
    assert first.stopped == "rounds" and 0 < first.spent < full.spent
    resumed = port_adaptive.adaptive_sweep(
        SPEC, GRID, BUDGET, runner=port_runner,
        atlas=AnomalyAtlas(path, FP, SPEC.name, 0.10))
    assert resumed.spent == full.spent <= BUDGET
    assert resumed.n_measured == full.spent - first.spent
    assert resumed.verdicts() == full.verdicts()


# ----------------------------------------------------------- shard fan-out --

def _lockstep(tmp_path, mask, n_hosts, budget=BUDGET):
    """Re-invoke every host until none is awaiting siblings."""
    paths = [atlas_shard_path(SPEC.name, FP, 0.10, k, tmp_path)
             for k in range(n_hosts)]
    for _ in range(40):
        done = True
        for k in range(n_hosts):
            last = port_adaptive.adaptive_sweep(
                SPEC, GRID, budget, shard=(k, n_hosts),
                atlas=AnomalyAtlas(paths[k], FP, SPEC.name, 0.10,
                                   shard=(k, n_hosts)),
                runner=port_synthetic.MaskRunner(mask))
            done = done and last.stopped != "awaiting-siblings"
        if done:
            return paths, last
    pytest.fail(f"{n_hosts}-way shard lockstep did not converge")


@pytest.mark.parametrize("n_hosts", (2, 3))
def test_shard_merge_equals_unsharded_point_for_point(tmp_path, n_hosts):
    port_runner, ref_runner = _pair("multi")
    ref = ref_adaptive.adaptive_sweep(REF_SPEC, GRID, BUDGET,
                                      runner=ref_runner)
    unsharded = port_adaptive.adaptive_sweep(
        SPEC, GRID, BUDGET, runner=port_runner,
        atlas=AnomalyAtlas(tmp_path / "whole.jsonl", FP, SPEC.name, 0.10))
    paths, last = _lockstep(tmp_path, port_runner.mask, n_hosts)
    assert last.stopped == ref.stopped
    per_shard = [{r.point for r in AnomalyAtlas(
        p, FP, SPEC.name, 0.10, shard=(k, n_hosts)).records()}
        for k, p in enumerate(paths)]
    union = set().union(*per_shard)
    assert sum(len(s) for s in per_shard) == len(union)
    assert union == set(ref.known) == set(unsharded.known)
    out = tmp_path / "merged.jsonl"
    report = _merge_mod().merge_shards(paths, out)
    assert report.n_records == len(ref.known)
    assert report.n_duplicates == report.n_conflicts == 0
    header = json.loads(out.read_text().splitlines()[0])
    assert "shard" not in header and header["timing"] == "eager"
    merged = {r.point: (r.cls, r.times, r.flops)
              for r in AnomalyAtlas(out, FP, SPEC.name, 0.10).records()}
    whole = {r.point: (r.cls, r.times, r.flops) for r in AnomalyAtlas(
        tmp_path / "whole.jsonl", FP, SPEC.name, 0.10).records()}
    assert merged == whole


def test_shard_atlas_never_mixes_with_canonical(tmp_path):
    port_runner, _ = _pair("blob")
    spath = atlas_shard_path(SPEC.name, FP, 0.10, 0, tmp_path)
    port_adaptive.adaptive_sweep(
        SPEC, GRID, 40, shard=(0, 2), runner=port_runner,
        atlas=AnomalyAtlas(spath, FP, SPEC.name, 0.10, shard=(0, 2)))
    with pytest.raises(AtlasError, match="atlas_merge"):
        AnomalyAtlas(spath, FP, SPEC.name, 0.10)
    with pytest.raises(AtlasError, match="shard"):
        AnomalyAtlas(spath, FP, SPEC.name, 0.10, shard=(1, 2))
    cpath = tmp_path / "canonical.jsonl"
    port_adaptive.adaptive_sweep(
        SPEC, GRID, 40, runner=port_runner,
        atlas=AnomalyAtlas(cpath, FP, SPEC.name, 0.10))
    with pytest.raises(AtlasError, match="shard"):
        AnomalyAtlas(cpath, FP, SPEC.name, 0.10, shard=(0, 2))
    with pytest.raises(ValueError, match="shard"):
        port_adaptive.adaptive_sweep(
            SPEC, GRID, 5, shard=(0, 2), runner=port_runner,
            atlas=AnomalyAtlas(cpath, FP, SPEC.name, 0.10))


def test_process_pool_rounds_equal_the_serial_run():
    """backend="process": one pool of spawned workers across every round."""
    port_runner, _ = _pair("stripe")
    serial = port_adaptive.adaptive_sweep(SPEC, GRID, BUDGET,
                                          runner=port_runner)
    pooled = port_adaptive.adaptive_sweep(
        SPEC, GRID, BUDGET, backend="process", shards=2,
        runner_factory=functools.partial(port_synthetic.MaskRunner,
                                         port_runner.mask))
    assert [r.admitted for r in pooled.rounds] == \
        [r.admitted for r in serial.rounds]
    assert pooled.verdicts() == serial.verdicts()


# -------------------------------------------------------------------- CLI --

CLI = ["--expr", "aatb", "--grid", "smoke", "--reps", "1", "--seed", "0",
       "--device", "cpu", "--quiet"]


def test_cli_adaptive_writes_a_replayable_atlas(tmp_path, capsys):
    args = CLI + ["--mode", "adaptive", "--budget", "6", "--atlas-dir",
                  str(tmp_path)]
    assert port_main(args) == 0
    out = capsys.readouterr().out
    assert "budget=6 spent=6 measured=6" in out and "stopped=budget" in out
    (path,) = tmp_path.glob("atlas-aatb-*.jsonl")
    assert json.loads(path.read_text().splitlines()[0])["timing"] == "eager"
    assert port_main(args) == 0
    assert "spent=6 measured=0" in capsys.readouterr().out


def test_cli_sharded_adaptive_lockstep_merge_and_reference_replay(tmp_path,
                                                                  capsys):
    base = CLI + ["--mode", "adaptive", "--budget", "8", "--atlas-dir",
                  str(tmp_path)]
    codes = set()
    for _ in range(10):
        rcs = [port_main(base + ["--shard", f"{k}/2"]) for k in (0, 1)]
        codes.update(rcs)
        if rcs == [0, 0]:
            break
    else:
        pytest.fail("CLI shard lockstep did not converge")
    assert 3 in codes             # somebody had to wait for a sibling
    capsys.readouterr()
    shards = sorted(tmp_path.glob("atlas-aatb-*-shard*.jsonl"))
    assert len(shards) == 2
    out = tmp_path / "merged.jsonl"
    report = _merge_mod().merge_shards(shards, out)
    assert report.n_records == 8 and report.n_duplicates == 0
    lines = out.read_text().splitlines()
    head = json.loads(lines[0])
    assert head["kind"] == "header" and "shard" not in head
    assert {"kernels", "fusion", "timing"} <= head.keys()
    pts = [tuple(json.loads(li)["point"]) for li in lines[1:]]
    assert len(pts) == 8 and pts == sorted(pts)
    # The port resumes the merged atlas; the reference replays it.
    assert len(AnomalyAtlas(out, FP, "AATB", 0.10)) == 8
    assert len(load_atlas_records(out).records) == 8


BAD_FLAGS = [
    ["--mode", "adaptive"],                                 # no --budget
    ["--budget", "6"],                                      # not adaptive
    ["--rounds", "2"],
    ["--shard", "0/2"],
    ["--mode", "adaptive", "--budget", "6", "--limit", "3"],
    ["--mode", "adaptive", "--budget", "6", "--compare-backends", "a,b"],
    ["--mode", "predict", "--compare-backends", "a,b"],
    ["--discriminants", "flops"],
]


@pytest.mark.parametrize("flags", BAD_FLAGS, ids=lambda f: " ".join(f))
def test_cli_usage_errors_are_the_references(tmp_path, capsys, flags):
    common = ["--expr", "aatb", "--grid", "smoke", "--atlas-dir",
              str(tmp_path), "--quiet"]
    for main, extra in ((port_main, ["--device", "cpu"]), (ref_main, [])):
        with pytest.raises(SystemExit) as exc:
            main(common + extra + flags)
        assert exc.value.code == 2
        assert "error:" in capsys.readouterr().err


@pytest.mark.parametrize("flags,message", [
    (["--mode", "adaptive", "--budget", "6", "--shard", "2/2"],
     "0 <= K < N"),
    (["--mode", "adaptive", "--budget", "6", "--shard", "x"], "K/N"),
    (["--compare-backends", "cuda,cuda"], "two distinct backend names"),
    (["--compare-backends", "cuda,nope"], "unknown backend"),
])
def test_cli_returns_2_as_the_reference_does(tmp_path, capsys, flags,
                                             message):
    common = ["--expr", "aatb", "--grid", "smoke", "--atlas-dir",
              str(tmp_path), "--quiet", "--reps", "1"]
    assert port_main(common + ["--device", "cpu"] + flags) == 2
    assert message in capsys.readouterr().err
    ref_flags = [f.replace("cuda", "blas") for f in flags]
    assert ref_main(common + ref_flags) == 2
    assert message in capsys.readouterr().err


def test_cli_rejects_no_tuning_until_the_tuner_is_ported(tmp_path, capsys,
                                                         monkeypatch):
    """The tuner is ported: ``--no-tuning`` is accepted, as in the
    reference, and sets ``REPRO_NO_TUNING`` (the reference's
    ``sweep.py:1191``), which the atlas header records as tuning=null."""
    # Empty (tuning on), and recorded, so that the value the CLI sets in
    # this process is undone after the test and leaks into no later one.
    monkeypatch.setenv("REPRO_NO_TUNING", "")
    assert port_main(CLI + ["--atlas-dir", str(tmp_path), "--no-tuning",
                            "--quiet"]) == 0
    assert os.environ.get("REPRO_NO_TUNING") == "1"
    [path] = tmp_path.glob("atlas-*.jsonl")
    assert json.loads(path.read_text().splitlines()[0])["tuning"] is None
