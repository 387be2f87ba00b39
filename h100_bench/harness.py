"""The benchmark's harness: it finds a cell's files by name, runs the
cell's traffic, reads its metrics and builds the result line.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by the name that ``BENCHMARK.json``
gives it:

* ``configs/<config>.json`` — the configuration as it is run;
* ``mixes/<traffic>.json`` — a traffic mix: its generator and parameters;
* ``traffic/<generator>.py`` — a generator, ``run(ctx) -> record``;
* ``workloads/<cell>.json`` — a cell's limits of the correctness check;
* ``metrics/<metric>.py`` — a reader, ``read(record) -> value or None``,
  most of them a line over ``readers.py`` (the program's spans and
  counters, a kernel's share of its roofline).

The record is a dict that the generator fills (set-up and window seconds,
counts, host-clock samples, the reduced device trace, in a traced run the
program's spans and counters, the numbers that the correctness check
compared); a reader that finds nothing to read returns None, and the
metric is left out of the line.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

#: Top-level module names that may not be loaded in a run: JAX and the
#: package the port was made from.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def process_start() -> float:
    """``time.perf_counter()`` at the start of this process, from
    ``/proc/self/stat`` (its start in clock ticks after boot) and
    ``/proc/uptime``; now, where they cannot be read."""
    now = time.perf_counter()
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return now


def cache_environment(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    os.environ["USE_FLAX"] = "0"
    src = root / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def cell_files(name: str, bench: Optional[dict] = None) -> dict:
    """{"entry", "config", "mix", "cell"} of workload ``name``."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    return {"entry": entry,
            "config": read_json(ROOT / cfg_entry["file"]),
            "mix": read_json(BENCH_DIR / "mixes" / f"{entry['traffic']}.json"),
            "cell": read_json(BENCH_DIR / "workloads" / f"{name}.json")}


def metrics_of(name: str, trace: bool, bench: Optional[dict] = None
               ) -> List[dict]:
    """The metrics that cell ``name`` reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    bench = bench or benchmark()
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def load_reader(metric: str):
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def port_config(cfg: dict):
    """The program's own configuration ``cfg["port"]["config"]`` with the
    values of ``cfg["port"]["set"]`` put in, checked against the file."""
    from repro_torch import configs
    port = cfg["port"]
    pc = configs.get(port["config"])
    for path, value in port.get("set", {}).items():
        pc = _replace(pc, path, value)
    check_port_config(cfg, pc)
    return pc


def lookup(obj, path: str):
    """``obj``'s value at the dotted ``path``: keys of a dict, attributes
    of anything else."""
    for part in path.split("."):
        obj = obj[part] if isinstance(obj, dict) else getattr(obj, part)
    return obj


def _replace(obj, path: str, value):
    """A copy of a frozen dataclass or a named tuple with the value at the
    dotted ``path`` replaced."""
    head, _, rest = path.partition(".")
    new = _replace(getattr(obj, head), rest, value) if rest else value
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{head: new})
    return obj._replace(**{head: new})


def check_port_config(cfg: dict, pc) -> None:
    """Every key of ``cfg["port"]["same"]`` (a path in the file) has the
    value of the program's attribute it names."""
    diff = {}
    for key, attr in cfg["port"]["same"].items():
        want, got = lookup(cfg, key), lookup(pc, attr)
        if want != got:
            diff[key] = (got, want)
    if diff:
        raise ValueError(f"{cfg['name']}: the program's configuration "
                         f"differs from the file's (program, file): {diff}")


class Context:
    """What a traffic generator gets: the cell's files, the run's
    arguments, the program's configuration and the device."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 device: str, files: dict, t_process: float,
                 port_cfg=None, control: bool = False):
        self.name, self.seed, self.seconds = name, int(seed), seconds
        self.trace, self.device = trace, device
        self.cfg = files["config"]
        self.params = files["mix"]["params"]
        self.t_process = t_process
        self.control = control
        self.port_cfg = port_cfg if port_cfg is not None \
            else port_config(self.cfg)

    def memory_peak(self) -> int:
        import torch
        if not self.device.startswith("cuda"):
            return 0
        return int(torch.cuda.max_memory_reserved(self.device))

    def free_device(self) -> None:
        import torch
        if self.device.startswith("cuda"):
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def judge(checks: Dict[str, float], limits: Dict[str, Any]
          ) -> Tuple[bool, Dict[str, dict]]:
    """The cell compares the numbers its file gives a limit: each has to
    be finite and at or under it; one that is missing or has no limit
    fails. Readings without a limit are not compared."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = checks.get(name)
        ok = ok and value is not None and limit is not None \
            and math.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit}
    return ok, out


def card_line() -> str:
    """Name and power limit of the card (``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
        return out.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_process: Optional[float] = None,
             files: Optional[dict] = None, port_cfg=None,
             control: bool = False) -> dict:
    """Run cell ``name`` and return its result line as a dict. ``files``
    and ``port_cfg`` replace the cell's files and the program's
    configuration (the tests run small sizes on the CPU); ``control``
    also reads the control of the correctness check (the reference in
    fp8 in the program's place) into the line's ``control`` key."""
    t_process = process_start() if t_process is None else t_process
    bench = benchmark()
    files = files or cell_files(name, bench)
    ctx = Context(name, seed, seconds, trace, device, files, t_process,
                  port_cfg, control)
    generator = importlib.import_module(
        f"h100_bench.traffic.{files['mix']['generator']}")
    record = generator.run(ctx)
    record.update(config=ctx.cfg, params=ctx.params,
                  device_name=_device_name(device))
    metrics = {}
    for m in metrics_of(name, trace, bench):
        value = load_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, checks = judge(record["checks"], files["cell"]["limits"])
    correct = correct and record.get("failed", 0) == 0
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": _device_name(device), "count": 1,
           "memory_peak_bytes": record["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": record.get("attempted", 0),
            "failed": record.get("failed", 0), "metrics": metrics,
            "device": dev}
    summary = record.get("trace")
    if trace and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        line["breakdown"] = {"device_ops": summary.top_ops(10),
                             "idle_gaps": summary.idle_gaps(10)}
    other = {k: v for k, v in record["checks"].items() if k not in checks}
    if other:
        record.setdefault("detail", {})["not_compared"] = other
    for key in ("control", "detail"):
        if key in record:
            line[key] = record[key]
    line["seed"] = int(seed)
    line["card"] = card_line() if device.startswith("cuda") else "cpu"
    line["checks"] = checks
    return line


def _device_name(device: str) -> str:
    import torch
    if device.startswith("cuda"):
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the reference
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
