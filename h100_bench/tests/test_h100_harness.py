"""The harness on the CPU: every cell's files exist and are found by
name, the metrics and names keep to the benchmark's contract, a run
without a card fails, nothing imports JAX or the reference package, the
trace reduction, and a small run of each cell end to end."""

import ast
import json
import math
import re
import subprocess
import sys
from types import SimpleNamespace

import pytest

from h100_bench import harness
from h100_bench.tests import smoke
from h100_bench.trace import TraceSummary
from h100_bench.traffic import train_loop

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist(cell):
    f = harness.cell_files(cell)
    assert (harness.BENCH_DIR / "traffic"
            / f"{f['mix']['generator']}.py").is_file()
    assert f["config"]["name"] == f["entry"]["config"]
    limits = f["cell"]["limits"]
    assert limits and all(isinstance(v, float) for v in limits.values())
    for m in harness.metrics_of(cell, False) + harness.metrics_of(cell, True):
        assert callable(harness.load_reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_the_contract_asks(cell):
    e2e = {m["name"] for m in harness.metrics_of(cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.metrics_of(cell, True)
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_moves_targets_are_reported_by_every_listed_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in target.get("workloads", CELLS), (m["name"], cell)


def test_names_units_and_bounds():
    names = [m["name"] for m in METRICS] + CELLS + \
        [c["name"] for c in BENCH["configs"]] + \
        [w["traffic"] for w in BENCH["workloads"]]
    for n in names:
        assert NAME.match(n), n
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_run_without_a_card_fails():
    out = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
         CELLS[0], "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "{" not in out.stdout


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_package_is_imported():
    files = [p for p in harness.BENCH_DIR.rglob("*.py")
             if "tests" not in p.parts]
    for p in files:
        top = set(_imports(p))
        assert not top & {"jax", "jaxlib", "flax", "repro"}, p
        if "reference" in p.parts:
            assert "repro_torch" not in top, p
    assert set(harness.FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", object())
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro", object())
    assert "repro" in harness.forbidden_modules()


def test_trace_summary():
    ivs = [(100, 200, "k1"), (150, 250, "k2"), (400, 500, "k1"),
           (900, 1200, "late")]
    marks = [(50, "start"), (300, "after_on_step"), (1000, "end")]
    t = TraceSummary(ivs, marks)
    assert t.window_s == pytest.approx(950e-9)
    assert t.busy_s == pytest.approx((150 + 100 + 100) * 1e-9)
    assert t.device_s() == pytest.approx((100 + 100 + 100 + 100) * 1e-9)
    assert t.device_s(contains="k1") == pytest.approx(200e-9)
    assert t.top_ops(1) == [["k1", pytest.approx(200e-9)]]
    gaps = t.idle_gaps(2)
    assert gaps[0] == ["after_on_step", pytest.approx(400e-9)]
    assert gaps[1] == ["after_on_step", pytest.approx(150e-9)]
    # the program's host ranges: a gap is named by the innermost range
    # open where the device starts again, else by the latest boundary
    ranges = [(850, 960, "train.loop.read_metrics"),
              (880, 920, "adamw.update"), (200, 260, "train.loop.on_step"),
              (390, 395, "train.loop.replay")]
    t = TraceSummary(ivs, marks, ranges)
    assert t.idle_gaps(3) == [["adamw.update", pytest.approx(400e-9)],
                              ["train.loop.replay", pytest.approx(150e-9)],
                              ["start", pytest.approx(50e-9)]]
    assert t.host_at(930) == "train.loop.read_metrics"
    assert t.host_at(350) == "after_on_step"


@pytest.mark.parametrize("cell", CELLS)
def test_small_run_on_the_cpu(cell):
    f, pc = smoke.files(cell, **smoke.TRAIN)
    line = harness.run_cell(cell, 2 ** 31 + 11, 0.5, False, device="cpu",
                            files=f, port_cfg=pc)
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    e2e = {m["name"] for m in harness.metrics_of(cell, False)}
    assert set(line["metrics"]) == e2e
    assert line["attempted"] > 0 and line["failed"] == 0
    limits = f["cell"]["limits"]
    assert set(line["checks"]) == set(limits)
    for name, c in line["checks"].items():
        assert math.isfinite(c["value"]) and c["limit"] == limits[name]


def _recorders_seen(monkeypatch):
    """The active span recorder at each of the loop's steps."""
    from repro_torch.runtime import spans
    seen, begin = [], spans.begin_step

    def begin_step(step):
        seen.append(spans.active())
        begin(step)

    monkeypatch.setattr(spans, "begin_step", begin_step)
    return seen


@pytest.mark.parametrize("cell", CELLS)
def test_an_untraced_run_makes_no_recorder(cell, monkeypatch):
    seen = _recorders_seen(monkeypatch)
    f, pc = smoke.files(cell, **smoke.TRAIN)
    line = harness.run_cell(cell, 2 ** 31 + 17, 0.3, False, device="cpu",
                            files=f, port_cfg=pc)
    assert line["correct"] and seen and set(seen) == {None}
    assert "spans" not in line["detail"] and "counts" not in line["detail"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_on_the_cpu_reads_spans_and_counters(cell, monkeypatch):
    seen = _recorders_seen(monkeypatch)
    f, pc = smoke.files(cell, **smoke.TRAIN)
    line = harness.run_cell(cell, 2 ** 31 + 19, 4.0, True, device="cpu",
                            files=f, port_cfg=pc)
    assert line["correct"] and seen and None not in seen
    detail = line["detail"]
    read = detail["span_steps"]
    assert 1 <= len(read) <= train_loop.SPAN_STEPS
    assert read == list(range(read[0], read[0] + len(read)))
    device = detail["spans"]["device"]
    for name in ("train.step", "train.forward", "train.backward",
                 "ssm.ssd", "ssm.ssd.bwd", "adamw.update"):
        total, own = device[name]
        assert total > 0 and -1e-6 <= own <= total + 1e-6
    assert "train.loop.eager_step" in detail["spans"]["host"]
    counts = detail["counts"]
    # every step runs the model's Python on the CPU: one pick a layer
    picks = counts.get("ssm.ssd.mode.chunked", 0) + \
        counts.get("ssm.ssd.mode.quadratic", 0)
    assert picks == pc.n_layers * (f["mix"]["params"]["check_steps"]
                                   + line["attempted"])
    assert counts.get("ssm.ssd.intra.kernel", 0) == 0
    # no device metric from the CPU's clocks; gaps carry the host's names
    assert set(line["metrics"]) <= {"train_step_wall_ms"}
    for name, _ in line["breakdown"]["idle_gaps"]:
        assert name.startswith("train.") or name in ("after_on_step", "end")


def test_port_config_compares_the_keys_the_file_names():
    # a configuration of another family: only the keys under port.same
    cfg = {"name": "x", "family": "dense", "d_model": 64,
           "attention": {"n_heads": 4},
           "port": {"same": {"d_model": "d_model",
                             "attention.n_heads": "attn.n_heads"}}}
    pc = SimpleNamespace(d_model=64, attn=SimpleNamespace(n_heads=4))
    harness.check_port_config(cfg, pc)
    pc.attn.n_heads = 8
    with pytest.raises(ValueError, match="attention.n_heads"):
        harness.check_port_config(cfg, pc)


def test_port_config_puts_in_the_files_values():
    cfg = harness.cell_files(CELLS[0])["config"]
    pc = harness.port_config(cfg)
    for path, value in cfg["port"]["set"].items():
        assert harness.lookup(pc, path) == value


def test_judge():
    ok, out = harness.judge({"a": 0.1, "b": 2.0, "c": 9.0},
                            {"a": 0.2, "b": 3.0})
    assert ok and out == {"a": {"value": 0.1, "limit": 0.2},
                          "b": {"value": 2.0, "limit": 3.0}}
    assert not harness.judge({"a": 0.3}, {"a": 0.2})[0]
    assert not harness.judge({"a": float("nan")}, {"a": 0.2})[0]
    assert not harness.judge({}, {"a": 0.2})[0]
    assert not harness.judge({"a": 0.1}, {"a": None})[0]
