"""The measured anomaly sweep, its sharded and pipelined engine, and the
persistent atlas.

The PyTorch port's counterpart of the reference package's
``core/sweep.py``: every algorithm of an expression is timed at each grid
point on an execution backend (by default the hand-written CUDA kernels;
on a card each algorithm is one replayed CUDA graph), each point is
classified (anomalous when the fastest algorithm is not among the
FLOP-cheapest, paper §3.3), and the results stream into a resumable JSONL
atlas keyed by the hardware fingerprint. The atlas has the reference's
header and record schema, so the reference's replay tools
(``repro.core.evaluate.load_atlas_records``, ``tools/atlas_merge.py``)
read a port atlas unchanged.

* :func:`sweep` — the one measurement path: serially in this process
  (with the fast path: operand arena, graph memo, pipelined preparation),
  over worker processes, or one process per card.
* :class:`AnomalyAtlas` — the resumable store; ``shard=(k, n)`` marks a
  host's shard file of a fanned-out adaptive sweep
  (:mod:`repro_torch.core.adaptive`).
* :func:`compare_backends` — ``--compare-backends torch,cuda`` (or
  ``blas,cuda``: the paper's library beside the hand-written kernels)
  diffs two backends' atlases: instances where the fastest algorithm
  differs.
* ``--mode predict`` classifies from per-kernel times measured in
  isolation (:func:`benchmark_unique_calls`) through the additive model;
  ``--mode evaluate`` replays the atlas and scores the registered
  discriminants (:mod:`repro_torch.core.evaluate`); ``--mode adaptive``
  refines around region frontiers under a budget.

CLI::

    PYTHONPATH=src python -m repro_torch.core.sweep --expr aatb --grid smoke
    PYTHONPATH=src python -m repro_torch.core.sweep --expr aatb --grid smoke  # resumes: measured=0
    PYTHONPATH=src python -m repro_torch.core.sweep --expr abcd --grid 400,1200 --seed 0
    PYTHONPATH=src python -m repro_torch.core.sweep --backend cuda --device cpu --grid smoke
    PYTHONPATH=src python -m repro_torch.core.sweep --backend blas --grid smoke --reps 1
    PYTHONPATH=src python -m repro_torch.core.sweep --compare-backends blas,torch --device cpu --grid smoke
    PYTHONPATH=src python -m repro_torch.core.sweep --expr abab --grid 400,800,1200 --no-fusion
    PYTHONPATH=src python -m repro_torch.core.sweep --expr aatb --grid 400,800,1200 --mode predict
    PYTHONPATH=src python -m repro_torch.core.sweep --expr aatb --grid 400,800,1200 --mode evaluate --discriminants flops,perfmodel,measured
    PYTHONPATH=src python -m repro_torch.core.sweep --expr aatb --grid 400,800,1200 --compare-backends torch,cuda
    PYTHONPATH=src python -m repro_torch.core.sweep --expr aatb --grid 40,80,...,1200 --mode adaptive --budget 400 [--shard 0/2]
    PYTHONPATH=src python -m repro_torch.core.sweep --list-exprs
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import multiprocessing
import os
import re
import sys
import time as _time
from concurrent.futures import (FIRST_COMPLETED, ProcessPoolExecutor,
                                ThreadPoolExecutor, wait)
from pathlib import Path
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import torch

from ..kernels import _build
from ..kernels import ops as kops
from .algorithms import Algorithm, Leaf
from .anomaly import (Classification, ConfusionMatrix, Region, classify,
                      cluster_regions, region_summary)
from .arena import (FastPathStats, OperandArena, arena_for, memo_counts,
                    order_points_for_locality)
from .backends import (backend_default_dtype, backend_shard_mode,
                       fusion_enabled, make_backend, register_torch_backends,
                       registered_backends, synthetic_algorithm, timing_mode)
from .expressions import (REGISTRY, SPECS, SWEEP_GRIDS,  # noqa: F401
                          ExpressionSpec, GridSpec, get_spec, registered_names)
from .fingerprint import HardwareFingerprint, cache_base_dir
from .flops import KernelCall
from .perfmodel import KernelProfile, TableProfile, predict_algorithm_time
from .tuning import ENV_NO_TUNING, atlas_tuning, runner_tuning

# --------------------------------------------------- instance measurement ---

#: Kill-switch for the measurement fast path (arena + graph memo +
#: pipelining). An environment variable, as in the reference, so worker
#: processes inherit one decision; ``sweep --no-fastpath`` sets it.
FASTPATH_ENV = "REPRO_NO_FASTPATH"


def fastpath_enabled(flag: Optional[bool] = None) -> bool:
    """Whether the measurement fast path is on (explicit flag wins)."""
    if flag is not None:
        return bool(flag)
    return not os.environ.get(FASTPATH_ENV)


def _leaf_bases(alg: Algorithm) -> set:
    """Distinct operand base indices an algorithm's steps reference."""
    return {ref.base for step in alg.steps for ref in (step.lhs, step.rhs)
            if isinstance(ref, Leaf)}


@dataclasses.dataclass
class Instance:
    """One fully measured grid point: per-algorithm times/FLOPs + verdict."""

    point: Tuple[int, ...]
    times: Dict[str, float]
    flops: Dict[str, int]
    cls: Classification


def _measure_prepared(point, algos, operands, runner,
                      threshold: float) -> Instance:
    """Time + classify one point whose algorithms/operands are in hand."""
    times: Dict[str, float] = {}
    flops: Dict[str, int] = {}
    for a in algos:
        times[a.name] = runner.time_algorithm(a, operands)
        flops[a.name] = a.flops
    cls = classify(times, flops, threshold=threshold)
    return Instance(tuple(int(x) for x in point), times, flops, cls)


def measure_instance(
    spec: ExpressionSpec,
    point: Sequence[int],
    runner,
    threshold: float = 0.10,
    arena: Optional[OperandArena] = None,
) -> Instance:
    """Time every algorithm for one instance and classify it.

    ``runner`` is any object with ``make_operands(alg) -> dict`` and
    ``time_algorithm(alg, operands) -> seconds`` — every registered
    execution backend qualifies. Operands are synthesized once per point
    and shared by all its algorithms; with an ``arena`` they are served
    from its shape-keyed pool instead. Timing is the same either way.
    """
    algos = spec.algorithms(point)
    if arena is not None:
        return _measure_prepared(point, algos, arena.operands(algos),
                                 runner, threshold)
    operands = runner.make_operands(algos[-1])
    for a in algos:
        if not _leaf_bases(a) <= operands.keys():
            for k, v in runner.make_operands(a).items():
                operands.setdefault(k, v)
    return _measure_prepared(point, algos, operands, runner, threshold)


# ------------------------------------------------------------------ atlas ---

ATLAS_SCHEMA_VERSION = 1

_ENV_ATLAS_DIR = "REPRO_ATLAS_DIR"


class AtlasError(RuntimeError):
    """Atlas file exists but belongs to a different sweep configuration."""


def atlas_dir() -> Path:
    env = os.environ.get(_ENV_ATLAS_DIR)
    if env:
        return Path(env)
    return cache_base_dir() / "atlas"


def _slug(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", s).lower()


def atlas_path(spec_name: str, fingerprint: HardwareFingerprint,
               threshold: float, directory: Optional[Path] = None) -> Path:
    d = Path(directory) if directory is not None else atlas_dir()
    t = f"{threshold:g}".replace(".", "p")
    return d / f"atlas-{_slug(spec_name)}-t{t}-{fingerprint.slug()}.jsonl"


def atlas_shard_path(spec_name: str, fingerprint: HardwareFingerprint,
                     threshold: float, shard_index: int,
                     directory: Optional[Path] = None) -> Path:
    """Per-host shard file of a fanned-out sweep: ``…-shardK.jsonl``.

    Same directory, naming scheme and header as the canonical atlas, so
    every shard carries the full configuration and
    ``tools/atlas_merge.py`` can refuse to mix incompatible ones.
    """
    base = atlas_path(spec_name, fingerprint, threshold, directory)
    return base.with_name(f"{base.stem}-shard{int(shard_index)}{base.suffix}")


def _instance_to_json(inst: Instance) -> dict:
    return {
        "point": list(inst.point),
        "is_anomaly": inst.cls.is_anomaly,
        "time_score": inst.cls.time_score,
        "flop_score": inst.cls.flop_score,
        "cheapest": list(inst.cls.cheapest),
        "fastest": list(inst.cls.fastest),
        "times": inst.times,
        "flops": inst.flops,
    }


def _instance_from_json(d: dict) -> Instance:
    cls = Classification(
        is_anomaly=bool(d["is_anomaly"]),
        time_score=float(d["time_score"]),
        flop_score=float(d["flop_score"]),
        cheapest=tuple(d["cheapest"]),
        fastest=tuple(d["fastest"]),
    )
    return Instance(
        point=tuple(int(x) for x in d["point"]),
        times={str(k): float(v) for k, v in d["times"].items()},
        flops={str(k): int(v) for k, v in d["flops"].items()},
        cls=cls,
    )


class AnomalyAtlas:
    """Persistent, resumable JSONL store of swept classifications.

    One file per (expression, anomaly threshold, hardware fingerprint).
    Line 1 is a header record ``{"kind": "header", ...}``; every other line
    is one instance. Appends are buffered and flushed in chunks of
    ``chunk_size`` (with fsync), so a killed sweep loses at most one
    unflushed chunk and a restart resumes from the last chunk: points
    already on disk are skipped by :func:`sweep`.

    Beyond the reference's header keys, the header names the program that
    measured: ``kernels``, the hash of the CUDA kernel sources
    (:func:`repro_torch.kernels._build.source_hash`; None for the
    ``torch`` backend), ``fusion``, whether fused dispatch was on, and
    ``timing``, what each time is of (``"graph"``: one replayed CUDA graph
    per algorithm, on a card; ``"eager"``: the walk, on the CPU and on the
    host backends ``blas`` and ``numpy``; see
    :func:`repro_torch.core.backends.timing_mode`), and ``tuning``, the
    digest of the tuning table the ``cuda`` backend launches under (None
    under ``REPRO_NO_TUNING``, without a table, or on another backend). It opens as the tuning state of ``runner`` when one is
    given, else as the cached table's digest
    (:func:`repro_torch.core.tuning.atlas_tuning`), and :func:`sweep`
    binds it to the measuring runner's own table before the first timing
    (:meth:`bind_tuning`). A resume under another value of any of them,
    or of an atlas whose header lacks one, is refused: one atlas never
    mixes two programs' timings.

    A torn final line (the kill landed mid-write) is tolerated on load;
    any undecodable line is skipped and counted in ``skipped_lines``.

    ``shard=(k, n)`` marks this file as host ``k``'s shard of an ``n``-way
    fanned-out sweep (:mod:`repro_torch.core.adaptive`): the header
    records it, and opening a shard file without the matching shard
    identity (or vice versa) is an :class:`AtlasError` — a shard never
    resumes as the canonical atlas before ``tools/atlas_merge.py`` has
    reconciled it.
    """

    def __init__(self, path: Path, fingerprint: HardwareFingerprint,
                 spec_name: str, threshold: float, chunk_size: int = 32,
                 shard: Optional[Tuple[int, int]] = None, runner=None):
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if shard is not None:
            k, n = int(shard[0]), int(shard[1])
            if not 0 <= k < n:
                raise ValueError(f"shard must be (k, n) with 0 <= k < n; "
                                 f"got {shard}")
            shard = (k, n)
        self.path = Path(path)
        self.fingerprint = fingerprint
        self.spec_name = spec_name
        self.threshold = float(threshold)
        self.shard = shard
        self.chunk_size = chunk_size
        cuda = fingerprint.backend == "cuda"
        self.program = {"kernels": _build.source_hash() if cuda else None,
                        "fusion": cuda and fusion_enabled(),
                        "timing": timing_mode(fingerprint.device,
                                              fingerprint.backend),
                        "tuning": (atlas_tuning(fingerprint)
                                   if runner is None
                                   else runner_tuning(runner))}
        self.skipped_lines = 0
        self._records: Dict[Tuple[int, ...], Instance] = {}
        self._buffer: List[str] = []
        self._header_on_disk = False
        self._needs_newline = False
        self.recovered_from: Optional[Path] = None
        if self.path.is_file():
            self._load()

    @classmethod
    def open(cls, spec_name: str, fingerprint: HardwareFingerprint,
             threshold: float = 0.10, directory: Optional[Path] = None,
             chunk_size: int = 32) -> "AnomalyAtlas":
        """Open (resuming) or create the atlas for this configuration."""
        path = atlas_path(spec_name, fingerprint, threshold, directory)
        return cls(path, fingerprint, spec_name, threshold,
                   chunk_size=chunk_size)

    # -- persistence ------------------------------------------------------
    def _header(self) -> dict:
        return {
            "kind": "header",
            "version": ATLAS_SCHEMA_VERSION,
            "spec": self.spec_name,
            "threshold": self.threshold,
            "fingerprint": self.fingerprint.to_dict(),
            **self.program,
            **({"shard": list(self.shard)} if self.shard is not None
               else {}),
        }

    def _load(self) -> None:
        with self.path.open() as f:
            first = f.readline()
            try:
                head = json.loads(first)
            except json.JSONDecodeError:
                # The kill landed mid-write of the header itself: keep the
                # torn file as a sidecar and start the atlas fresh.
                side = self.path.with_suffix(self.path.suffix + ".corrupt")
                self.path.replace(side)
                self.recovered_from = side
                return
            if head.get("kind") != "header":
                raise AtlasError(f"atlas {self.path} is missing its header")
            if head.get("version") != ATLAS_SCHEMA_VERSION:
                raise AtlasError(
                    f"atlas {self.path} has schema version "
                    f"{head.get('version')!r}; this build reads "
                    f"{ATLAS_SCHEMA_VERSION}")
            fp = HardwareFingerprint.from_dict(head["fingerprint"])
            if fp != self.fingerprint:
                raise AtlasError(
                    f"atlas {self.path} was swept on {fp}, but this "
                    f"process targets {self.fingerprint}")
            if head.get("spec") != self.spec_name or \
                    abs(head.get("threshold", -1) - self.threshold) > 1e-12:
                raise AtlasError(
                    f"atlas {self.path} records spec="
                    f"{head.get('spec')!r}/threshold="
                    f"{head.get('threshold')!r}, not "
                    f"{self.spec_name!r}/{self.threshold}")
            head_shard = head.get("shard")
            want_shard = list(self.shard) if self.shard is not None else None
            if head_shard != want_shard:
                raise AtlasError(
                    f"atlas {self.path} records shard={head_shard}, but "
                    f"this process opened it as shard={want_shard} — merge "
                    f"shards with tools/atlas_merge.py instead of mixing")
            if not self.program.keys() <= head.keys():
                raise AtlasError(
                    f"atlas {self.path} does not record the kernel sources, "
                    f"the fusion setting, the timing and the tuning it was "
                    f"measured with; start a fresh atlas (another "
                    f"--atlas-dir, --fresh, or delete it)")
            recorded = {key: head[key] for key in self.program}
            if recorded != self.program:
                raise AtlasError(
                    f"atlas {self.path} was measured with kernels="
                    f"{recorded['kernels']!r} fusion={recorded['fusion']!r}, "
                    f"but this process runs kernels="
                    f"{self.program['kernels']!r} fusion="
                    f"{self.program['fusion']!r}; the atlas was timed "
                    f"{recorded['timing']!r}, this process times "
                    f"{self.program['timing']!r}; the atlas was tuned by "
                    f"table {recorded['tuning']!r}, this process by "
                    f"{self.program['tuning']!r}")
            self._header_on_disk = True
            raw = first
            for raw in f:
                line = raw.strip()
                if not line:
                    continue
                try:
                    inst = _instance_from_json(json.loads(line))
                except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                    # Torn tail from a killed writer (or a corrupt line):
                    # drop it; the sweep will re-measure that point.
                    self.skipped_lines += 1
                    continue
                self._records[inst.point] = inst
            # A torn tail has no trailing newline; flush starts with one so
            # the next record is not merged into the garbage line.
            self._needs_newline = not raw.endswith("\n")

    def bind_tuning(self, tuning: Optional[str]) -> None:
        """Record ``tuning``, the measuring runner's tuning state
        (:func:`~repro_torch.core.tuning.runner_tuning`), as the header's.
        An atlas whose header is on disk must already record it."""
        if tuning == self.program["tuning"]:
            return
        if self._header_on_disk:
            raise AtlasError(
                f"atlas {self.path} was tuned by table "
                f"{self.program['tuning']!r}, but its runner launches "
                f"under {tuning!r}; one atlas never mixes two programs' "
                f"timings")
        self.program["tuning"] = tuning

    def append(self, inst: Instance) -> bool:
        """Add one instance; returns False (no write) for known points."""
        if inst.point in self._records:
            return False
        self._records[inst.point] = inst
        self._buffer.append(json.dumps(_instance_to_json(inst),
                                       sort_keys=True))
        if len(self._buffer) >= self.chunk_size:
            self.flush()
        return True

    def flush(self) -> None:
        """Durably write buffered records (chunk boundary for resume)."""
        if not self._buffer and self._header_on_disk:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self.path.open("a") as f:
            if self._needs_newline:
                f.write("\n")
                self._needs_newline = False
            if not self._header_on_disk:
                f.write(json.dumps(self._header(), sort_keys=True) + "\n")
                self._header_on_disk = True
            for line in self._buffer:
                f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._buffer.clear()

    def __enter__(self) -> "AnomalyAtlas":
        return self

    def __exit__(self, *exc) -> None:
        self.flush()

    # -- queries ----------------------------------------------------------
    def __contains__(self, point: Sequence[int]) -> bool:
        return tuple(int(x) for x in point) in self._records

    def __len__(self) -> int:
        return len(self._records)

    def get(self, point: Sequence[int]) -> Optional[Instance]:
        return self._records.get(tuple(int(x) for x in point))

    def records(self) -> List[Instance]:
        return list(self._records.values())

    def anomalies(self) -> List[Instance]:
        return [r for r in self._records.values() if r.cls.is_anomaly]


# ---------------------------------------------------------------- engines ---


def _factory_key(factory) -> object:
    """Identity of a runner factory that survives pickling.

    ``functools.partial`` compares by object identity, and every chunk
    shipped to a worker unpickles to a *new* partial — so the worker-local
    runner cache keys on (func, args, kwargs) instead.
    """
    if isinstance(factory, functools.partial):
        return (factory.func, factory.args,
                tuple(sorted(factory.keywords.items())))
    return factory


_worker_runner: Optional[Tuple[object, object]] = None  # (key, runner)


def _measure_chunk(spec: ExpressionSpec, points: Sequence[Tuple[int, ...]],
                   runner_factory: Callable[[], object],
                   threshold: float, fastpath: bool = True,
                   ) -> Tuple[List[Instance], Dict[str, float]]:
    """Worker process: measure one chunk of points.

    Module-level (picklable); each worker builds its own runner and keeps
    it for its lifetime, with its arena and graph memo, so reuse compounds
    across every chunk the worker sees. Returns the measured instances
    plus this chunk's fast-path counter deltas.
    """
    global _worker_runner
    key = _factory_key(runner_factory)
    if _worker_runner is None or _worker_runner[0] != key:
        register_torch_backends()   # a spawned worker starts from imports
        _worker_runner = (key, runner_factory())
    runner = _worker_runner[1]
    if not (fastpath and fastpath_enabled()):
        return ([measure_instance(spec, p, runner, threshold)
                 for p in points], {})
    arena = arena_for(runner)
    stats = FastPathStats()
    a0, m0 = arena.snapshot(), memo_counts(runner)
    out = [measure_instance(spec, p, runner, threshold, arena=arena)
           for p in order_points_for_locality(points)]
    stats.add_arena_delta(a0, arena.snapshot())
    stats.add_memo_delta(m0, memo_counts(runner))
    return out, stats.as_dict()


def _chunked(seq: Sequence, size: int) -> List[Sequence]:
    return [seq[i:i + size] for i in range(0, len(seq), size)]


def _run_serial(spec, points, runner, threshold, on_done) -> None:
    for p in points:
        on_done(measure_instance(spec, p, runner, threshold))


def _run_serial_fastpath(spec, points, runner, threshold, on_done,
                         stats: FastPathStats) -> None:
    """Arena + pipelined serial measurement (the fast path).

    Points are *measured* in locality order (lexicographic — identical to
    row-major grid order) while one helper thread prepares point ``k+1``
    during point ``k``'s timing: the enumeration and the first stage of
    the arena, which synthesizes on the host and touches no device. The
    second stage, placing new buffers on the card, runs here, before the
    point's first clock starts: no copy to the card runs inside a timed
    repetition, and no other thread calls CUDA while a graph is captured.
    Instances are *emitted* strictly in request order through a small
    reorder buffer, so atlas bytes and progress callbacks are those of the
    path without it.
    """
    from collections import deque

    arena = arena_for(runner)
    order = order_points_for_locality(points)
    emit_q = deque(points)                       # request order
    ready: Dict[Tuple[int, ...], Instance] = {}
    memo0 = memo_counts(runner)
    a0 = arena.snapshot()

    def flush_ready() -> None:
        while emit_q and emit_q[0] in ready:
            on_done(ready.pop(emit_q.popleft()))

    def prepare(p):
        t0 = _time.perf_counter()
        algos = spec.algorithms(p)
        staged = arena.stage(algos)
        return p, algos, staged, _time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=1) as helper:
        nxt = helper.submit(prepare, order[0])
        for i in range(len(order)):
            t_wait = _time.perf_counter()
            p, algos, staged, prep_s = nxt.result()
            waited = _time.perf_counter() - t_wait
            stats.prep_s += prep_s
            # Preparation time not spent blocking here ran concurrently
            # with the previous point's measurement.
            stats.overlap_s += max(0.0, prep_s - waited)
            operands = arena.place(staged)
            if i + 1 < len(order):
                nxt = helper.submit(prepare, order[i + 1])
                stats.points_pipelined += 1
            ready[p] = _measure_prepared(p, algos, operands, runner,
                                         threshold)
            flush_ready()
    flush_ready()
    stats.add_arena_delta(a0, arena.snapshot())
    stats.add_memo_delta(memo0, memo_counts(runner))


def _spawn_pool(workers: int) -> ProcessPoolExecutor:
    """Worker processes started with *spawn*: a forked child of a process
    that has initialised CUDA cannot use it."""
    return ProcessPoolExecutor(max_workers=workers,
                               mp_context=multiprocessing.get_context("spawn"))


def _drain(pending, on_done, stats: Optional[FastPathStats]) -> None:
    """Hand each finished chunk's instances to ``on_done`` as chunks
    complete (so the atlas keeps filling while workers run)."""
    while pending:
        done, pending = wait(pending, return_when=FIRST_COMPLETED)
        for fut in done:
            insts, chunk_stats = fut.result()
            for inst in insts:
                on_done(inst)
            if stats is not None and chunk_stats:
                stats.merge(FastPathStats.from_dict(chunk_stats))


def _run_process_pool(spec, points, runner_factory, threshold, shards,
                      chunk_size, on_done, executor=None,
                      fastpath: bool = True,
                      stats: Optional[FastPathStats] = None) -> None:
    """Shard points over a pool of worker processes.

    Chunks are submitted eagerly but results are drained as they complete,
    so a kill mid-pool still leaves every completed chunk on disk. An
    ``executor`` passed in is reused and left open (callers measuring many
    point sets pay process start-up once). ``runner_factory`` must pickle
    by import path (e.g. ``functools.partial(make_backend, "cuda", ...)``
    or a :class:`~repro_torch.core.synthetic.MaskRunner`).
    """
    chunks = _chunked(points, chunk_size)
    own = executor is None
    pool = executor if executor is not None else _spawn_pool(shards)
    try:
        _drain({pool.submit(_measure_chunk, spec, c, runner_factory,
                            threshold, fastpath) for c in chunks},
               on_done, stats)
    finally:
        if own:
            pool.shutdown()


def card_devices(device: str = "cuda",
                 shards: Optional[int] = None) -> List[str]:
    """The devices a device-sharded sweep measures on: every card (at most
    ``shards``) for ``"cuda"``, else ``device`` alone (``"cpu"``, or one
    named card such as ``"cuda:1"``)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [str(dev)]
    n = torch.cuda.device_count()
    if shards:
        n = min(n, shards)
    return [f"cuda:{i}" for i in range(max(n, 1))]


def _run_devices(spec, points, threshold, reps, exec_backend, dtype,
                 devices: Sequence[str], on_done, seed=None,
                 fastpath: bool = True, chunk_size: int = 8,
                 stats: Optional[FastPathStats] = None) -> None:
    """Shard points across devices, one worker process per device.

    The counterpart of the reference's ``_run_jax_devices``: each device
    gets a round-robin share of the points, measured in chunks by its own
    single-worker process (spawned, holding one backend pinned to the
    device, with its arena and graph memo) in submission order, while the
    devices run concurrently; instances stream to ``on_done`` as chunks
    finish. On one device this is the serial path in this process.
    """
    if backend_shard_mode(exec_backend) != "device":
        raise ValueError(
            f"backend='devices' fans a device backend out over cards; "
            f"{exec_backend!r} runs on the host (backend='process' fans it "
            f"out over worker processes)")
    if len(devices) <= 1:
        runner = make_backend(exec_backend, device=devices[0], reps=reps,
                              dtype=dtype, seed=seed)
        if fastpath:
            _run_serial_fastpath(spec, points, runner, threshold, on_done,
                                 stats)
        else:
            _run_serial(spec, points, runner, threshold, on_done)
        return
    pools = [_spawn_pool(1) for _ in devices]
    try:
        pending = set()
        for i, (dev, pool) in enumerate(zip(devices, pools)):
            factory = functools.partial(make_backend, exec_backend,
                                        device=dev, reps=reps, dtype=dtype,
                                        seed=seed)
            for chunk in _chunked(points[i::len(devices)], chunk_size):
                pending.add(pool.submit(_measure_chunk, spec, chunk, factory,
                                        threshold, fastpath))
        _drain(pending, on_done, stats)
    finally:
        for pool in pools:
            pool.shutdown()


# ------------------------------------------------------------------ sweep ---


@dataclasses.dataclass
class SweepResult:
    spec_name: str
    records: List[Instance]   # one per requested point (measured or cached)
    n_measured: int
    n_skipped: int            # points served from the atlas
    wall_s: float
    atlas_path: Optional[Path] = None
    #: Fast-path counters (arena/memo hits, pipeline overlap); ``None``
    #: when the path without it ran (``--no-fastpath``).
    fastpath: Optional[FastPathStats] = None

    @property
    def n_points(self) -> int:
        return len(self.records)

    @property
    def anomalies(self) -> List[Instance]:
        return [r for r in self.records if r.cls.is_anomaly]

    @property
    def anomaly_rate(self) -> float:
        return len(self.anomalies) / len(self.records) if self.records \
            else 0.0

    @property
    def instances_per_s(self) -> float:
        return self.n_measured / self.wall_s if self.wall_s > 0 else 0.0


def sweep(
    spec: ExpressionSpec,
    points: Sequence[Sequence[int]],
    *,
    runner=None,
    runner_factory: Optional[Callable[[], object]] = None,
    threshold: float = 0.10,
    backend: str = "serial",
    shards: Optional[int] = None,
    atlas: Optional[AnomalyAtlas] = None,
    chunk_size: int = 8,
    max_instances: Optional[int] = None,
    reps: int = 3,
    exec_backend: Optional[str] = None,
    device: str = "cuda",
    dtype: Optional[str] = None,
    executor=None,
    progress: Optional[Callable[[int, int, Instance], None]] = None,
    fastpath: Optional[bool] = None,
    seed: Optional[int] = None,
) -> SweepResult:
    """Measure + classify a set of instances — the one measurement path.

    ``backend`` picks the *sharding strategy*; ``exec_backend`` names the
    *execution backend* (a registry key, default ``cuda``) the workers
    are built from when no explicit ``runner``/``runner_factory`` is given:

    * ``backend="serial"``  — this process: ``runner``, or
      ``runner_factory()``, or ``exec_backend`` on ``device``;
    * ``backend="process"`` — ``shards`` spawned worker processes, each
      building its runner from ``runner_factory`` (a picklable zero-arg
      callable), defaulting to ``exec_backend`` on ``device`` (the fan-out
      of the host backends ``blas`` and ``numpy``);
    * ``backend="devices"`` — one spawned process per card
      (:func:`card_devices`; at most ``shards``), each with its own
      ``exec_backend`` instance; on one card, or ``device="cpu"``, the
      serial path.

    Points already in ``atlas`` are *skipped* (served from disk), which is
    what makes a restarted sweep resume; newly measured instances stream
    into the atlas and are flushed in chunks. ``max_instances`` caps new
    measurements. Requested-point order is preserved in the result.
    On the serial path the atlas's ``tuning`` is bound to the runner's
    own table before the first timing (:meth:`AnomalyAtlas.bind_tuning`;
    a resumed atlas of another tuning state raises :class:`AtlasError`);
    the ``process`` and ``devices`` workers auto-load the cached table
    the header names.
    ``executor`` (process backend) is a pool to reuse, left open.
    ``dtype`` (default: the backend's own) and ``device`` configure the
    runners the sweep builds; ``make_backend`` hands ``device`` to no host
    backend (``blas``, ``numpy``: float64 on the host).

    ``fastpath`` controls the measurement fast path (operand arena, graph
    memo counters, locality order, pipelined preparation): ``None``
    follows ``REPRO_NO_FASTPATH``, ``True``/``False`` force it. Timing is
    the same either way; the result's ``fastpath`` field carries the
    counters. ``seed`` makes operand synthesis reproducible (each leaf a
    pure function of ``(seed, base, shape)``) for runners the sweep builds.
    """
    if atlas is not None and abs(atlas.threshold - threshold) > 1e-12:
        raise ValueError(
            f"atlas {atlas.path} records threshold {atlas.threshold}, but "
            f"sweep() was called with threshold {threshold} — cached and "
            f"new classifications would silently disagree")
    if runner is not None and backend != "serial":
        raise ValueError(
            f"runner= only configures the serial backend; backend="
            f"{backend!r} builds its own workers (pass runner_factory for "
            f"'process', or exec_backend/reps/device for 'devices') — "
            f"refusing to silently measure with a different configuration")
    want = list(dict.fromkeys(tuple(int(x) for x in p) for p in points))
    for p in want:
        if len(p) != spec.ndims:
            raise ValueError(
                f"point {p} has {len(p)} dims but expression {spec.name} "
                f"takes {spec.ndims} — check the grid's ndims")
    cached: Dict[Tuple[int, ...], Instance] = {}
    todo: List[Tuple[int, ...]] = []
    for p in want:
        hit = atlas.get(p) if atlas is not None else None
        if hit is not None:
            cached[p] = hit
        else:
            todo.append(p)
    if max_instances is not None:
        todo = todo[:max_instances]

    measured: Dict[Tuple[int, ...], Instance] = {}
    n_total = len(todo)
    fp_on = fastpath_enabled(fastpath)
    stats = FastPathStats() if fp_on else None
    exec_backend = exec_backend or "cuda"
    t0 = _time.perf_counter()

    def on_done(inst: Instance) -> None:
        measured[inst.point] = inst
        if atlas is not None:
            atlas.append(inst)
        if progress is not None:
            progress(len(measured), n_total, inst)

    try:
        if not todo:
            pass
        elif backend == "serial":
            r = runner
            if r is None:
                if runner_factory is not None:
                    r = runner_factory()
                else:
                    register_torch_backends()
                    r = make_backend(exec_backend, device=device, reps=reps,
                                     dtype=dtype, seed=seed)
            if atlas is not None:
                atlas.bind_tuning(runner_tuning(r))
            if fp_on:
                _run_serial_fastpath(spec, todo, r, threshold, on_done,
                                     stats)
            else:
                _run_serial(spec, todo, r, threshold, on_done)
        elif backend == "process":
            if runner_factory is None:
                register_torch_backends()
                runner_factory = functools.partial(
                    make_backend, exec_backend, device=device, reps=reps,
                    dtype=dtype, seed=seed)
            _run_process_pool(spec, todo, runner_factory, threshold,
                              shards or os.cpu_count() or 1, chunk_size,
                              on_done, executor=executor, fastpath=fp_on,
                              stats=stats)
        elif backend == "devices":
            register_torch_backends()
            _run_devices(spec, todo, threshold, reps, exec_backend, dtype,
                         card_devices(device, shards), on_done, seed=seed,
                         fastpath=fp_on, chunk_size=chunk_size, stats=stats)
        else:
            raise ValueError(
                f"unknown backend {backend!r}; expected "
                f"serial|process|devices")
    finally:
        if atlas is not None:
            atlas.flush()

    records = [cached.get(p) or measured[p] for p in want
               if p in cached or p in measured]
    return SweepResult(
        spec_name=spec.name,
        records=records,
        n_measured=len(measured),
        n_skipped=len(cached),
        wall_s=_time.perf_counter() - t0,
        atlas_path=atlas.path if atlas is not None else None,
        fastpath=stats,
    )


def cluster_sweep(records, grid: GridSpec) -> List[Region]:
    """Cluster a swept grid's anomalies into contiguous regions.

    Records off the grid are ignored — adjacency is only defined on the
    grid's axes.
    """
    axes_sets = [set(ax) for ax in grid.axes]
    scores: Dict[Tuple[int, ...], Tuple[float, float]] = {}
    for r in records:
        if not r.cls.is_anomaly:
            continue
        if all(v in s for v, s in zip(r.point, axes_sets)):
            scores[r.point] = (r.cls.time_score, r.cls.flop_score)
    return cluster_regions(scores, grid.axes)


def cluster_predictions(
    predicted: Mapping[Tuple[int, ...], Classification],
    grid: GridSpec,
) -> List[Region]:
    """Cluster predicted (model-only) classifications over a grid."""
    scores = {p: (c.time_score, c.flop_score)
              for p, c in predicted.items() if c.is_anomaly}
    return cluster_regions(scores, grid.axes)


# --------------------------------------------- batched kernel measurement ---

def element_bytes(dtype: str) -> int:
    """Bytes per element the models charge for a measuring backend's
    dtype, by the reference's rule: 8 for float64, else 4."""
    return 8 if dtype == "float64" else 4


def collect_unique_calls(
    spec: ExpressionSpec, points: Iterable[Sequence[int]],
) -> List[KernelCall]:
    """Distinct kernel calls across every algorithm of every point.

    Across a grid, neighbouring instances' algorithms share most calls, so
    the unique set is far smaller than the naive call stream — this dedup
    is what makes predicted sweeps (and Experiment 3) cheap.
    """
    seen: Dict[KernelCall, None] = {}
    for p in points:
        for a in spec.algorithms(p):
            for call in a.calls:
                seen.setdefault(call)
    return list(seen)


def benchmark_unique_calls(
    runner,
    calls: Iterable[KernelCall],
    profile: Optional[TableProfile] = None,
    reps: Optional[int] = None,
    progress: Optional[Callable[[int, int, KernelCall], None]] = None,
    arena: Optional[OperandArena] = None,
    stats: Optional[FastPathStats] = None,
) -> Tuple[TableProfile, int, int]:
    """Benchmark the deduplicated call set, reusing ``profile`` entries.

    Returns ``(profile, n_measured, n_reused)``. Calls the profile already
    covers are never re-measured — so a persisted calibration makes repeat
    sweeps nearly free, and every new measurement lands in the profile for
    the *next* consumer (the calibration-cache feedback loop). Each call
    is timed in isolation as one synthetic one-step algorithm through
    ``runner.time_algorithm`` (a warm-up and ``reps`` timed runs). With an
    ``arena``, its operands come from the shape-keyed pool; ``stats``
    receives the arena and memo counters.
    """
    calls = list(dict.fromkeys(calls))
    if profile is None:
        profile = TableProfile(peak_flops=1.0)
    n_measured = n_reused = 0
    n_calls = len(calls)
    a0 = arena.snapshot() if arena is not None else None
    m0 = memo_counts(runner)
    for i, call in enumerate(calls):
        if call in profile:
            n_reused += 1
            continue
        if arena is not None:
            alg = synthetic_algorithm(call)
            seconds = runner.time_algorithm(alg, arena.operands([alg]),
                                            reps=reps)
        else:
            seconds = runner.benchmark_call(call, reps=reps)
        profile.record(call, seconds)
        n_measured += 1
        if seconds > 0 and call.flops:
            # cached profiles included: a newly observed best throughput
            # raises peak_flops so efficiency stays a true fraction
            profile.observe_peak(call.flops / seconds)
        if progress is not None:
            progress(i + 1, n_calls, call)
    if stats is not None:
        if arena is not None:
            stats.add_arena_delta(a0, arena.snapshot())
        stats.add_memo_delta(m0, memo_counts(runner))
    return profile, n_measured, n_reused


def predict_classifications(
    spec: ExpressionSpec,
    points: Iterable[Sequence[int]],
    profile: KernelProfile,
    threshold: float = 0.10,
    dtype_bytes: int = 4,
) -> Dict[Tuple[int, ...], Classification]:
    """Classify every point from the additive per-kernel model (no timing).

    This is the paper's Experiment-3 prediction generalized to arbitrary
    point sets: with a calibrated profile it maps anomaly regions at grid
    scale in milliseconds. The model sums ``alg.calls``, one term per
    step, also where the ``cuda`` backend runs two steps as one fused
    kernel, and charges ``dtype_bytes`` an element (the measuring
    backend's, :func:`element_bytes`).
    """
    out: Dict[Tuple[int, ...], Classification] = {}
    for p in points:
        p = tuple(int(x) for x in p)
        algos = spec.algorithms(p)
        times = {a.name: predict_algorithm_time(a.calls, profile, dtype_bytes)
                 for a in algos}
        flops = {a.name: a.flops for a in algos}
        out[p] = classify(times, flops, threshold=threshold)
    return out


# ------------------------------------------------- cross-backend diffing ---


@dataclasses.dataclass
class BackendDisagreement:
    """One instance where two backends' verdicts differ."""

    point: Tuple[int, ...]
    fastest: Dict[str, Tuple[str, ...]]   # backend -> fastest set
    is_anomaly: Dict[str, bool]
    time_score: Dict[str, float]


@dataclasses.dataclass
class BackendComparison:
    """Diff of two per-backend atlases over one point set.

    ``fastest_differs`` lists instances whose fastest-algorithm sets are
    *disjoint* across the two backends — the same math, a different
    winning kernel sequence because the kernel implementations differ
    (on the port: plain ATen against the hand-written kernels).
    ``anomaly_differs`` lists instances whose anomaly verdicts disagree.
    """

    spec_name: str
    backends: Tuple[str, str]
    n_points: int
    fastest_differs: List[BackendDisagreement]
    anomaly_differs: List[BackendDisagreement]
    results: Dict[str, SweepResult]

    @property
    def fastest_differs_rate(self) -> float:
        return len(self.fastest_differs) / self.n_points if self.n_points \
            else 0.0


def compare_backends(
    spec: ExpressionSpec,
    points: Sequence[Sequence[int]],
    sweeps: Mapping[str, SweepResult],
) -> BackendComparison:
    """Diff two (or more — pairwise over the first two) backend sweeps.

    ``sweeps`` maps backend name -> the :func:`sweep` result for *the
    same* spec and point set on that backend. Points missing from either
    result (e.g. budget-capped partial sweeps) are skipped.
    """
    names = list(sweeps)
    if len(names) < 2:
        raise ValueError("compare_backends needs at least two sweeps")
    a_name, b_name = names[0], names[1]
    by_point = {
        name: {r.point: r for r in res.records}
        for name, res in sweeps.items()
    }
    want = [tuple(int(x) for x in p) for p in points]
    fastest_differs: List[BackendDisagreement] = []
    anomaly_differs: List[BackendDisagreement] = []
    n = 0
    for p in want:
        ra = by_point[a_name].get(p)
        rb = by_point[b_name].get(p)
        if ra is None or rb is None:
            continue
        n += 1
        d = BackendDisagreement(
            point=p,
            fastest={a_name: ra.cls.fastest, b_name: rb.cls.fastest},
            is_anomaly={a_name: ra.cls.is_anomaly,
                        b_name: rb.cls.is_anomaly},
            time_score={a_name: ra.cls.time_score,
                        b_name: rb.cls.time_score},
        )
        if not (set(ra.cls.fastest) & set(rb.cls.fastest)):
            fastest_differs.append(d)
        if ra.cls.is_anomaly != rb.cls.is_anomaly:
            anomaly_differs.append(d)
    return BackendComparison(
        spec_name=spec.name,
        backends=(a_name, b_name),
        n_points=n,
        fastest_differs=fastest_differs,
        anomaly_differs=anomaly_differs,
        results=dict(sweeps),
    )


# -------------------------------------------------------------------- CLI ---


def parse_grid(spec: ExpressionSpec, text: str) -> GridSpec:
    """A named grid, or comma-separated axis values shared by every dim."""
    if text in SWEEP_GRIDS or text in spec.grids:
        return spec.grid(text)
    try:
        values = [int(v) for v in text.split(",") if v.strip()]
    except ValueError:
        raise ValueError(
            f"--grid must name one of {sorted(SWEEP_GRIDS)} or be "
            f"comma-separated ints; got {text!r}") from None
    return GridSpec.uniform(values, spec.ndims)


def _registry_epilog() -> str:
    """The family, discriminant, backend and analysis-rule registries,
    generated when the parser is built so the help text never omits an
    entry."""
    from .cli_help import (analysis_rules_epilog, backends_epilog,
                           discriminants_epilog)

    lines = ["registered expression families (repro_torch.core.expressions):"]
    for cli_name in registered_names():
        s = REGISTRY[cli_name]
        lines.append(f"  {cli_name:<7} {s.name:<7} ndims={s.ndims}  "
                     f"{s.description}")
    return "\n".join(lines) + "\n\n" + discriminants_epilog() + "\n\n" \
        + backends_epilog() + "\n\n" + analysis_rules_epilog()


def _note(msg: str, quiet: bool) -> None:
    if not quiet:
        print(msg, file=sys.stderr)
        sys.stderr.flush()


def main(argv: Optional[List[str]] = None) -> int:
    register_torch_backends()
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.sweep",
        description="Measured anomaly sweep over a problem-size grid on "
                    "the PyTorch port; results persist in the resumable "
                    "anomaly atlas.",
        epilog=_registry_epilog(),
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--expr", choices=registered_names(), default="aatb",
                    help="expression family to sweep (see the registry "
                         "listing below)")
    ap.add_argument("--list-exprs", action="store_true",
                    help="print the registered expression families (one "
                         "CLI name per line) and exit")
    ap.add_argument("--grid", default="small",
                    help=f"named grid {sorted(SWEEP_GRIDS)} or "
                         "comma-separated axis values, e.g. 400,800,1200")
    ap.add_argument("--mode",
                    choices=("measure", "predict", "evaluate", "adaptive"),
                    default="measure",
                    help="measure: time every algorithm per instance; "
                         "predict: classify from per-kernel benchmarks "
                         "timed in isolation (additive model; feeds the "
                         "profile cache); evaluate: replay the persisted "
                         "atlas and score discriminants (top-1 accuracy, "
                         "time regret, anomaly recall/precision) without "
                         "timing anything; adaptive: coarse seed + "
                         "boundary-refinement rounds under --budget "
                         "(resumable; shardable across hosts with --shard)")
    ap.add_argument("--budget", type=int, default=None,
                    help="adaptive mode: total trajectory budget in grid "
                         "points (seed + refinement, global across "
                         "--shard hosts); resumed runs honor what "
                         "remains of it")
    ap.add_argument("--rounds", type=int, default=None,
                    help="adaptive mode: max refinement rounds (default: "
                         "until the budget runs out or a round finds no "
                         "new frontier)")
    ap.add_argument("--seed-stride", type=int, default=4,
                    help="adaptive mode: seed lattice stride in grid "
                         "indices (endpoints always included); regions "
                         "narrower than this can be missed")
    ap.add_argument("--shard", default=None, metavar="K/N",
                    help="adaptive mode: run host K of an N-way fan-out "
                         "— measures every N-th refinement candidate "
                         "into its own atlas-…-shardK.jsonl, reading "
                         "sibling shards back each round; merge with "
                         "tools/atlas_merge.py (exit 3 = waiting on "
                         "siblings, rerun after they advance)")
    ap.add_argument("--discriminants", default=None, metavar="A,B,C",
                    help="comma-separated repro_torch.core.discriminants "
                         "registry keys to score in --mode evaluate "
                         "(default: every registered discriminant)")
    ap.add_argument("--backend", choices=registered_backends(),
                    default="cuda",
                    help="cuda: the hand-written kernels; torch: plain "
                         "ATen; blas: scipy BLAS in float64 on the host "
                         "(the paper's protocol); numpy: the float64 "
                         "oracle on the host; each gets its own "
                         "fingerprint-keyed atlas")
    ap.add_argument("--compare-backends", default=None, metavar="A,B",
                    help="sweep the grid on two backends (e.g. torch,cuda "
                         "or blas,cuda) and report instances where the "
                         "fastest algorithm differs by backend (overrides "
                         "--backend)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu, "
                         "where the kernels' plain versions run; blas and "
                         "numpy run on the host and ignore it")
    ap.add_argument("--shards", type=int, default=1,
                    help="torch and cuda: cards to fan the sweep out over, "
                         "one worker process each (0 = every card; on the "
                         "CPU the sweep runs in this process); blas and "
                         "numpy: worker processes (1 = this process)")
    ap.add_argument("--threshold", type=float, default=0.10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-flush", action="store_true",
                    help="skip the per-repetition cache flush of blas and "
                         "numpy; the torch and cuda backends do not flush "
                         "(L2 stays warm across repetitions, as in the "
                         "reference's device backends), so it changes "
                         "nothing there")
    ap.add_argument("--no-fusion", action="store_true",
                    help="cuda: disable fused adjacent-step dispatch (sets "
                         "REPRO_NO_FUSION) — every step launches its own "
                         "kernel")
    ap.add_argument("--no-tuning", action="store_true",
                    help="cuda: ignore the tuning table (sets "
                         "REPRO_NO_TUNING) — every kernel launches as its "
                         "wrapper's cost model picks; the atlas header "
                         "records tuning=null, so a tuned and a default "
                         "atlas of one grid make the tuned vs default "
                         "anomaly map")
    ap.add_argument("--no-fastpath", action="store_true",
                    help="disable the measurement fast path (operand "
                         "arena, pipelined preparation; sets "
                         "REPRO_NO_FASTPATH) — timing is the same either "
                         "way, this is the bisect switch")
    ap.add_argument("--seed", type=int, default=None,
                    help="operand-synthesis seed: every leaf becomes a "
                         "pure function of (seed, base, shape), so reruns "
                         "and shards draw identical operands")
    ap.add_argument("--limit", type=int, default=None,
                    help="measure at most N new instances this run "
                         "(budgeted partial sweep; resume later)")
    ap.add_argument("--atlas-dir", type=Path, default=None,
                    help="atlas directory (default: $REPRO_ATLAS_DIR or "
                         "~/.cache/repro/atlas)")
    ap.add_argument("--fresh", action="store_true",
                    help="delete any existing atlas file first")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.list_exprs:
        for cli_name in registered_names():
            print(cli_name)
        return 0
    # Process-wide on purpose, as in the reference: the walker reads these
    # at every dispatch and worker processes inherit them.
    if args.no_fusion:
        os.environ["REPRO_NO_FUSION"] = "1"
    if args.no_tuning:
        os.environ[ENV_NO_TUNING] = "1"
    if args.no_fastpath:
        os.environ[FASTPATH_ENV] = "1"

    spec = get_spec(args.expr)
    try:
        grid = parse_grid(spec, args.grid)
    except ValueError as e:
        ap.error(str(e))
    points = grid.points()

    if args.discriminants and args.mode != "evaluate":
        # Scoring is a replay-only concern; silently accepting the flag
        # on a measured sweep would imply the sweep was somehow filtered.
        ap.error("--discriminants only applies to --mode evaluate")
    if args.mode == "adaptive":
        if args.budget is None:
            ap.error("--mode adaptive requires --budget (the point of "
                     "the mode is a bounded measurement budget)")
        if args.limit is not None:
            ap.error("--limit is the dense-sweep budget knob; adaptive "
                     "mode budgets via --budget")
        if args.compare_backends:
            ap.error("--compare-backends diffs dense atlases; run "
                     "adaptive sweeps per backend and merge/compare "
                     "their atlases instead")
    else:
        for flag, val in (("--budget", args.budget),
                          ("--rounds", args.rounds),
                          ("--shard", args.shard)):
            if val is not None:
                ap.error(f"{flag} only applies to --mode adaptive")
    if args.compare_backends:
        if args.mode != "measure":
            # Comparison diffs *measured* atlases; silently degrading an
            # explicit --mode predict into two measured sweeps could cost
            # a long unrequested run on a dense grid.
            ap.error("--compare-backends runs measured sweeps; it cannot "
                     "be combined with --mode predict")
        return _main_compare(args, spec, grid, points)

    name = args.backend
    if args.mode == "evaluate":
        return _main_evaluate(args, spec, grid)
    if args.mode == "adaptive":
        return _main_adaptive(args, spec, grid, name)

    atlas = _open_backend_atlas(spec, name, args)
    _note(f"sweep {spec.name} grid={grid.name} ({grid.n_points} "
          f"instances over {spec.ndims} dims), backend={name} on "
          f"{atlas.fingerprint.device} shards={args.shards}; atlas "
          f"{atlas.path} ({len(atlas)} already recorded)", args.quiet)
    if args.mode == "predict":
        return _main_predict(args, spec, grid, atlas)

    kops.reset_launch_counts()
    res = _backend_sweep(spec, points, name, args, atlas)
    print(f"sweep {spec.name}/{grid.name} [{name}]: "
          f"points={res.n_points} measured={res.n_measured} "
          f"skipped={res.n_skipped} anomalies={len(res.anomalies)} "
          f"({res.anomaly_rate:.1%}) in {res.wall_s:.1f}s "
          f"[{res.instances_per_s:.1f} inst/s]")
    if res.fastpath is not None and res.n_measured:
        print(f"fastpath: {res.fastpath.summary()}")
    print("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in kops.launch_counts().items()))
    print(region_summary(cluster_sweep(res.records, grid), res.n_points))
    print(f"atlas written to {res.atlas_path}")
    return 0


def _open_backend_atlas(spec, name, args,
                        shard: Optional[Tuple[int, int]] = None
                        ) -> AnomalyAtlas:
    """The per-backend atlas, fingerprinted by the registry key, the
    device and the dtype; ``shard=(k, n)`` opens host k's shard file of an
    n-way adaptive fan-out instead of the canonical atlas."""
    from .profile_store import current_fingerprint

    fp = current_fingerprint(backend=name, dtype=backend_default_dtype(name),
                             device=args.device)
    if shard is not None:
        path = atlas_shard_path(spec.name, fp, args.threshold, shard[0],
                                args.atlas_dir)
    else:
        path = atlas_path(spec.name, fp, args.threshold, args.atlas_dir)
    if args.fresh and path.is_file():
        path.unlink()
    return AnomalyAtlas(path, fp, spec.name, args.threshold, shard=shard)


def _engine_config(name, args) -> dict:
    """Fan-out and runner settings for one registry backend, from the CLI.

    Follows the backend's ``shard_mode``. A host backend (``blas``,
    ``numpy``) never sees ``--device``: with ``--shards N > 1`` it fans
    out over N spawned worker processes, each building its own runner,
    else one runner is built here (one flush buffer for the run). A
    device backend (``torch``, ``cuda``): with one device to measure on
    (the CPU, one card, or ``--shards 1``) one runner is built here, so
    its arena and graph memo last across every ``sweep`` call of the run
    (adaptive rounds included); with more, one worker process per card.
    Shared by the dense sweep and the adaptive engine, so both modes
    measure identically.
    """
    if backend_shard_mode(name) == "process":
        options = dict(reps=args.reps, flush_cache=not args.no_flush,
                       seed=args.seed)
        if args.shards > 1:
            return dict(backend="process", shards=args.shards,
                        runner_factory=functools.partial(
                            make_backend, name, **options),
                        reps=args.reps)
        return dict(runner=make_backend(name, **options), reps=args.reps)
    if len(card_devices(args.device, args.shards or None)) > 1:
        return dict(backend="devices", exec_backend=name, device=args.device,
                    shards=args.shards or None, reps=args.reps,
                    seed=args.seed)
    return dict(runner=make_backend(name, device=args.device, reps=args.reps,
                                    flush_cache=not args.no_flush,
                                    seed=args.seed),
                reps=args.reps)


def _backend_sweep(spec, points, name, args, atlas) -> SweepResult:
    """One measured dense sweep on one registry backend, from the CLI."""
    def progress(i, n, inst):
        if not args.quiet and (i % 25 == 0 or i == n):
            _note(f"  [{name} {i}/{n}] {inst.point} "
                  f"{'ANOMALY' if inst.cls.is_anomaly else 'ok'} "
                  f"ts={inst.cls.time_score:.1%}", args.quiet)

    return sweep(spec, points, threshold=args.threshold, atlas=atlas,
                 max_instances=args.limit, progress=progress,
                 **_engine_config(name, args))


def _parse_shard(text: str) -> Tuple[int, int]:
    try:
        k, n = (int(x) for x in text.split("/", 1))
    except ValueError:
        raise ValueError(f"--shard takes K/N (e.g. 0/4), got {text!r}")
    if not 0 <= k < n:
        raise ValueError(f"--shard needs 0 <= K < N, got {text!r}")
    return k, n


def _main_adaptive(args, spec, grid, name) -> int:
    """--mode adaptive: budgeted boundary refinement, optionally sharded.

    Exit 3 means a sharded host is waiting on sibling shard files —
    re-invoke once the other hosts advance; the trajectory replays from
    the shard atlas, so the retry costs no re-measurement.
    """
    from .adaptive import adaptive_sweep, boundary_cells

    try:
        shard = _parse_shard(args.shard) if args.shard else None
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    atlas = _open_backend_atlas(spec, name, args, shard=shard)
    _note(f"adaptive sweep {spec.name} grid={grid.name} "
          f"({grid.n_points} grid points, budget={args.budget}, "
          f"seed stride={args.seed_stride}), backend={name}"
          + (f", shard {shard[0]}/{shard[1]}" if shard else ""),
          args.quiet)
    _note(f"atlas: {atlas.path} ({len(atlas)} instances already recorded)",
          args.quiet)
    kops.reset_launch_counts()
    res = adaptive_sweep(
        spec, grid, args.budget, args.rounds, threshold=args.threshold,
        atlas=atlas, shard=shard, seed_stride=args.seed_stride,
        **_engine_config(name, args))
    frontier = boundary_cells(res.verdicts(), grid)
    print(f"adaptive {spec.name}/{grid.name} [{name}]: "
          f"budget={res.budget} spent={res.spent} "
          f"measured={res.n_measured} rounds={res.n_refine_rounds} "
          f"stopped={res.stopped} "
          f"({res.spent / grid.n_points:.1%} of dense, "
          f"{len(frontier)} frontier cells) in {res.wall_s:.1f}s")
    print("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in kops.launch_counts().items()))
    print(region_summary(res.regions(), len(res.known)))
    print(f"atlas written to {res.atlas_path}")
    if res.stopped == "awaiting-siblings":
        _note("waiting on sibling shards — rerun this command after the "
              "other hosts advance, then merge with tools/atlas_merge.py",
              args.quiet)
        return 3
    return 0


def _main_compare(args, spec, grid, points) -> int:
    """--compare-backends A,B: sweep both, diff fastest sets + verdicts."""
    names = [n.strip() for n in args.compare_backends.split(",") if
             n.strip()]
    if len(names) != 2 or names[0] == names[1]:
        print(f"--compare-backends takes two distinct backend names, got "
              f"{args.compare_backends!r}", file=sys.stderr)
        return 2
    for n in names:
        if n not in registered_backends():
            print(f"unknown backend {n!r}; registered: "
                  f"{registered_backends()}", file=sys.stderr)
            return 2
    sweeps: Dict[str, SweepResult] = {}
    for n in names:
        atlas = _open_backend_atlas(spec, n, args)
        _note(f"sweep {spec.name} grid={grid.name} backend={n} "
              f"(atlas: {atlas.path}, {len(atlas)} recorded)", args.quiet)
        sweeps[n] = _backend_sweep(spec, points, n, args, atlas)
        res = sweeps[n]
        print(f"sweep {spec.name}/{grid.name} [{n}]: points={res.n_points} "
              f"measured={res.n_measured} skipped={res.n_skipped} "
              f"anomalies={len(res.anomalies)} ({res.anomaly_rate:.1%}) "
              f"in {res.wall_s:.2f}s")
    cmp = compare_backends(spec, points, sweeps)
    a, b = cmp.backends
    print(f"compare {spec.name}/{grid.name} [{a} vs {b}]: "
          f"points={cmp.n_points} "
          f"fastest-differs={len(cmp.fastest_differs)} "
          f"({cmp.fastest_differs_rate:.1%}) "
          f"anomaly-verdict-differs={len(cmp.anomaly_differs)}")
    for d in cmp.fastest_differs:
        print(f"  {d.point}: {a} fastest={'/'.join(d.fastest[a])} "
              f"(ts={d.time_score[a]:.1%}) | "
              f"{b} fastest={'/'.join(d.fastest[b])} "
              f"(ts={d.time_score[b]:.1%})")
    for n in names:
        print(f"atlas[{n}] written to {sweeps[n].atlas_path}")
    return 0


def _main_predict(args, spec, grid, atlas) -> int:
    """--mode predict: per-kernel benchmarks → model-only sweep."""
    from .profile_store import load_default_profile, save_profile

    runner = make_backend(args.backend, device=args.device, reps=args.reps,
                          flush_cache=not args.no_flush, seed=args.seed)
    points = grid.points()
    cached = load_default_profile(backend=args.backend, dtype=runner.dtype,
                                  device=args.device)
    calls = collect_unique_calls(spec, points)
    fp_on = fastpath_enabled()
    arena = arena_for(runner) if fp_on else None
    stats = FastPathStats() if fp_on else None
    kops.reset_launch_counts()
    t0 = _time.perf_counter()
    profile, n_meas, n_reused = benchmark_unique_calls(
        runner, calls, profile=cached, reps=args.reps, arena=arena,
        stats=stats)
    bench_s = _time.perf_counter() - t0
    save_profile(profile, atlas.fingerprint,
                 meta={"source": f"sweep:{spec.name}"})
    if stats is not None and n_meas:
        _note(f"fastpath: {stats.summary()}", args.quiet)
    predicted = predict_classifications(
        spec, points, profile, threshold=args.threshold,
        dtype_bytes=element_bytes(runner.dtype))
    n_anom = sum(1 for c in predicted.values() if c.is_anomaly)
    print(f"predict {spec.name}/{grid.name}: points={len(points)} "
          f"unique_kernels={len(calls)} measured={n_meas} "
          f"reused={n_reused} in {bench_s:.1f}s; "
          f"predicted anomalies={n_anom} ({n_anom / len(points):.1%})")
    print("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in kops.launch_counts().items()))
    print(region_summary(cluster_predictions(predicted, grid), len(points)))
    if len(atlas):
        # Confusion vs whatever ground truth the atlas already holds.
        cm = ConfusionMatrix()
        for p, c in predicted.items():
            actual = atlas.get(p)
            if actual is not None:
                cm.add(actual.cls.is_anomaly, c.is_anomaly)
        if cm.total:
            print(f"vs atlas ground truth ({cm.total} instances): "
                  f"recall={cm.recall:.1%} precision={cm.precision:.1%}")
    return 0


def _main_evaluate(args, spec, grid) -> int:
    """--mode evaluate: replay the atlas, score discriminants, no timing.

    The atlas is loaded through the *lenient* replay loader
    (:func:`repro_torch.core.evaluate.load_atlas_records`): evaluation
    never appends, so fingerprints are not matched against this process.
    If the fingerprint-exact file is absent but exactly one atlas for this
    (spec, threshold) exists — e.g. ground truth swept on another machine
    — that one is used, with a note. Profile-consuming policies read the
    profile cached for this backend and device, if any.
    """
    from .discriminants import registered_discriminants
    from .evaluate import evaluate_discriminants, load_atlas_records
    from .profile_store import current_fingerprint, load_default_profile

    if args.discriminants:
        names = [n.strip() for n in args.discriminants.split(",")
                 if n.strip()]
        unknown = [n for n in names if n.lower()
                   not in registered_discriminants()]
        if unknown:
            print(f"unknown discriminant(s) {unknown}; registered: "
                  f"{registered_discriminants()}", file=sys.stderr)
            return 2
    else:
        names = registered_discriminants()

    dtype = backend_default_dtype(args.backend)
    fp = current_fingerprint(backend=args.backend, dtype=dtype,
                             device=args.device)
    path = atlas_path(spec.name, fp, args.threshold, args.atlas_dir)
    if not path.is_file():
        t = f"{args.threshold:g}".replace(".", "p")
        candidates = [
            c for c in sorted(path.parent.glob(
                f"atlas-{_slug(spec.name)}-t{t}-*.jsonl"))
            # Un-merged shard files (the reference's fanned-out sweeps)
            # are partial by construction; replay a merged atlas instead.
            if not re.search(r"-shard\d+$", c.stem)
        ]
        if len(candidates) == 1:
            _note(f"no atlas for this fingerprint; evaluating the only "
                  f"match {candidates[0].name}", args.quiet)
            path = candidates[0]
        else:
            hint = (f"{len(candidates)} atlases match this spec/threshold"
                    if candidates else "none exist")
            print(f"no atlas at {path} ({hint}); sweep ground truth first: "
                  f"python -m repro_torch.core.sweep --expr {args.expr} "
                  f"--grid {args.grid} --backend {args.backend} --device "
                  f"{args.device}", file=sys.stderr)
            return 2

    replay = load_atlas_records(path)
    want = set(grid.points())
    records = [r for r in replay.records if r.point in want]
    if not records:
        # Grid mismatch (or a random-search atlas): score what exists
        # rather than erroring — the atlas is the ground truth we have.
        _note(f"no atlas records on grid {grid.name}; evaluating all "
              f"{len(replay.records)} recorded instances", args.quiet)
        records = replay.records
    if not records:
        print(f"atlas {path} holds no instances", file=sys.stderr)
        return 2

    profile = load_default_profile(backend=args.backend, dtype=dtype,
                                   device=args.device)
    try:
        res = evaluate_discriminants(
            spec, records, [n.lower() for n in names], profile=profile,
            threshold=args.threshold, dtype_bytes=element_bytes(dtype))
    except ValueError as e:
        # Record-level defect (atlas swept under a different enumeration):
        # every row would be wrong, so the evaluation itself fails.
        print(f"evaluation failed: {e}", file=sys.stderr)
        return 1
    rows = []
    for score in res.scores.values():
        row = score.row()
        if score.error is not None and score.error.startswith("KeyError"):
            # The documented partial-calibration failure mode; other
            # errors get no hint — switching discriminants won't fix them.
            row += " (hint: `hybrid` tolerates partial calibrations)"
        rows.append(row)
    if all(s.error is not None for s in res.scores.values()):
        print("every requested discriminant failed to evaluate:",
              file=sys.stderr)
        for row in rows:
            print("  " + row, file=sys.stderr)
        return 1
    legacy = " legacy-fingerprint" if replay.legacy else ""
    print(f"evaluate {spec.name}/{grid.name} [{args.backend}]: "
          f"instances={res.n_instances} anomalies={res.n_anomalies} "
          f"profile={'cached' if profile is not None else 'analytical'}"
          f"{legacy}")
    for row in rows:
        print("  " + row)
    print(f"atlas read from {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
