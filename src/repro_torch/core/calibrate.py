"""Calibration: measure this machine's kernel profile, once.

The port's counterpart of the reference package's ``core/calibrate.py``.
The paper's conclusion — FLOPs alone mispredict; combine them with kernel
performance models — needs those models to exist for *this* hardware.
:func:`calibrate` times every kernel call of a grid in isolation
(gemm/syrk/symm over a log-spaced dim grid, plus tri2full) on an
execution backend — by default ``cuda``, the hand-written kernels on the
card; ``blas`` is the paper's float64 BLAS protocol on the host — builds
a measured :class:`~repro_torch.core.perfmodel.TableProfile` and persists
it via :mod:`repro_torch.core.profile_store`, keyed by the backend, the
card's name (the host's ISA for ``blas`` and ``numpy``) and the dtype.

Each entry is ``ExecutionBackend.benchmark_call``: one synthetic one-step
algorithm, a warm-up and ``reps`` timed runs, median of the host clock
around a synchronised run — so it holds the host's work around the
launch as well as the kernel's.

CLI::

    PYTHONPATH=src python -m repro_torch.core.calibrate --grid small
    PYTHONPATH=src python -m repro_torch.core.calibrate --expr aatb --grid 400,800,1200
    PYTHONPATH=src python -m repro_torch.core.calibrate --backend torch --device cpu --grid tiny
    PYTHONPATH=src python -m repro_torch.core.calibrate --backend blas --grid tiny
    PYTHONPATH=src python -m repro_torch.core.calibrate --backend torch --dtype bfloat16 --device cpu --grid tiny
    PYTHONPATH=src python -m repro_torch.core.calibrate --tune --grid default --tune-budget 8

``--tune`` measures the kernels' launches instead of a profile
(:func:`tune`): it writes the
:class:`~repro_torch.core.tuning.TuningTable` the ``cuda`` backend
auto-loads.

Grids are named (tiny/small/default/full) rather than free-form so cache
files produced on different machines cover comparable shape ranges; with
``--expr`` the grid is the family's sweep grid (a name or comma-separated
axis values).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path
from typing import Iterable, List, Optional

from .backends import (backend_on, get_backend_class, register_torch_backends,
                       registered_backends)
from .flops import KernelCall, gemm, symm, syrk, tri2full
from .perfmodel import TableProfile
from .profile_store import (
    HardwareFingerprint,
    load_profile,
    profile_path,
    save_profile,
)

# Log-spaced (power-of-two) dim grids. "small" finishes in seconds and is
# meant for tests/smoke; "default" is the per-machine calibration;
# "full" approaches the paper's boxes.
GRIDS = {
    "tiny": (64, 128),
    "small": (64, 128, 256),
    "default": (32, 64, 128, 256, 512, 1024),
    "full": (32, 64, 128, 256, 512, 1024, 1536, 2048),
}


def expression_calls(spec, grid: str = "small") -> List[KernelCall]:
    """The deduplicated kernel-call set of one registered expression family
    over a sweep grid — the targeted alternative to the full
    :func:`grid_calls` cross product.

    ``grid`` is a sweep grid name or comma-separated axis values, as
    ``python -m repro_torch.core.sweep --grid`` reads it, so a machine can
    be calibrated for exactly the shapes one family's sweep will predict
    with (``--mode predict``).
    """
    from .sweep import collect_unique_calls, parse_grid
    return collect_unique_calls(spec, parse_grid(spec, grid).points())


def grid_calls(grid: Iterable[int]) -> List[KernelCall]:
    """Every kernel call the sweep measures, in deterministic order.

    gemm covers the full (m, n, k) cross product — the aspect-ratio
    extremes are exactly where efficiency cliffs live (paper Fig. 1) —
    while syrk/symm take (m, k)/(m, n) pairs and tri2full the diagonal.
    """
    dims = sorted(set(int(d) for d in grid))
    calls: List[KernelCall] = []
    for m in dims:
        for n in dims:
            for k in dims:
                calls.append(gemm(m, n, k))
    for m in dims:
        for k in dims:
            calls.append(syrk(m, k))
    for m in dims:
        for n in dims:
            calls.append(symm(m, n))
    for m in dims:
        calls.append(tri2full(m))
    return calls


@dataclasses.dataclass
class CalibrationResult:
    profile: TableProfile
    fingerprint: HardwareFingerprint
    path: Optional[Path]      # None when persistence was disabled
    wall_s: float
    n_calls: int


def sweep_kernels(
    runner,
    grid: Iterable[int],
    reps: int = 3,
    dtype: Optional[str] = None,
    progress=None,
    calls: Optional[List[KernelCall]] = None,
) -> TableProfile:
    """Benchmark every grid call in isolation; returns the measured table.

    ``runner`` is any object with ``benchmark_call(call, reps=None) ->
    float`` — every registered execution backend qualifies, and its
    dtype, device and timing protocol live on the runner instance.
    ``dtype`` is a consistency guard only: if the runner declares a dtype,
    a mismatch raises rather than stamping a fingerprint the measurements
    don't match. Peak FLOP/s is estimated as the best throughput observed
    anywhere in the sweep, so ``TableProfile.efficiency`` is relative to
    this machine's own best. ``calls`` overrides the measured set (e.g.
    one expression family's deduplicated calls from
    :func:`expression_calls`); ``grid`` is ignored then.
    """
    runner_dtype = getattr(runner, "dtype", None)
    if dtype is not None and runner_dtype is not None \
            and runner_dtype != dtype:
        raise ValueError(
            f"runner measures dtype {runner_dtype!r} but the sweep was "
            f"asked to label {dtype!r}")
    calls = grid_calls(grid) if calls is None else list(calls)
    n_calls = len(calls)
    table = {}
    peak = 1.0
    for i, call in enumerate(calls):
        seconds = runner.benchmark_call(call, reps=reps)
        table[(call.kind, call.dims)] = seconds
        if seconds > 0 and call.flops:
            peak = max(peak, call.flops / seconds)
        if progress:
            progress(i + 1, n_calls, call, seconds)
    return TableProfile(peak_flops=peak, table=table)


def calibrate(
    backend: str = "cuda",
    grid: str = "small",
    reps: int = 3,
    out: Optional[Path] = None,
    dtype: Optional[str] = None,
    save: bool = True,
    progress=None,
    expr: Optional[str] = None,
    seed: Optional[int] = None,
    device: str = "cuda",
) -> CalibrationResult:
    """Measure + persist this machine's kernel profile.

    ``out`` is a *directory*; the filename is derived from the hardware
    fingerprint so calibrations for different backends, devices and
    dtypes coexist. With ``out=None`` the default cache dir is used —
    where :func:`~repro_torch.core.profile_store.load_default_profile`
    (and so ``sweep --mode predict|evaluate``) looks.

    ``expr`` (a registered expression CLI name) restricts the measured set
    to exactly the kernel calls that family's sweep grid enumerates —
    ``grid`` then names a *sweep* grid (a name or comma-separated axis
    values) rather than a calibration grid — and merges the new entries
    into the profile already saved for this fingerprint.

    ``device`` is where a device backend runs: ``cuda`` (the default;
    raises without a card) or ``cpu``; the host backends ``blas`` and
    ``numpy`` ignore it. ``dtype`` labels what is measured: ``torch``
    takes float64, float32, bfloat16 and float16, the other backends
    their one dtype, and any other label raises ``ValueError``. ``seed``
    pins operand synthesis: each benchmark operand becomes a pure
    function of ``(seed, base, shape)``.
    """
    calls = None
    if expr is not None:
        from .expressions import get_spec
        calls = expression_calls(get_spec(expr), grid)
    elif grid not in GRIDS:
        raise ValueError(f"unknown grid {grid!r}; expected {sorted(GRIDS)}")
    register_torch_backends()
    if backend not in registered_backends():
        raise ValueError(
            f"unknown backend {backend!r}; registered: "
            f"{registered_backends()}")
    runner = backend_on(backend, device, reps=reps, dtype=dtype, seed=seed)
    fp = runner.fingerprint()
    t0 = time.perf_counter()
    profile = sweep_kernels(runner, GRIDS.get(grid, ()), reps=reps,
                            dtype=dtype, progress=progress, calls=calls)
    wall = time.perf_counter() - t0
    if expr is not None:
        # A family-targeted run is *additive*: merge the new measurements
        # into whatever calibration this fingerprint already has — saving
        # the small restricted table wholesale would gut a full-grid
        # calibration sharing the same cache path.
        prev_path = profile_path(fp, directory=out)
        if prev_path.is_file():
            prev, _ = load_profile(prev_path, expected_fingerprint=fp)
            # Rebind rather than update() in place: TableProfile's
            # nearest-neighbour bucket index invalidates on rebinding.
            prev.table = {**prev.table, **profile.table}
            prev.observe_peak(profile.peak())
            profile = prev
    path = None
    if save:
        meta = {"grid": grid, "reps": reps, "wall_s": round(wall, 3)}
        if expr is not None:
            meta["expr"] = expr
        path = save_profile(profile, fp, directory=out, meta=meta)
    return CalibrationResult(profile=profile, fingerprint=fp, path=path,
                             wall_s=wall, n_calls=len(profile.table))


@dataclasses.dataclass
class TuneResult:
    table: object                 # repro_torch.core.tuning.TuningTable
    fingerprint: HardwareFingerprint
    path: Optional[Path]          # None when persistence was disabled
    wall_s: float
    n_requests: int


def tune(
    backend: str = "cuda",
    grid: str = "tiny",
    reps: int = 3,
    out: Optional[Path] = None,
    dtype: Optional[str] = None,
    save: bool = True,
    budget: int = 8,
    progress=None,
    seed: Optional[int] = None,
    device: str = "cuda",
) -> TuneResult:
    """``calibrate --tune``: autotune the kernels' launches, persist the
    winners.

    The tuning sibling of :func:`calibrate`: the same named grids, the
    same fingerprint, the same cache directory — but the measured object
    is a :class:`~repro_torch.core.tuning.TuningTable` of winning launch
    configs (one per ``(kind, dims)``; tri2full has none, and the grid's
    diagonal adds the two fused patterns), pruned before any timing and
    measured under a per-request ``budget``. Only a backend whose kernels
    take launch configs can be tuned: ``cuda``.
    """
    if grid not in GRIDS:
        raise ValueError(f"unknown grid {grid!r}; expected {sorted(GRIDS)}")
    register_torch_backends()
    if backend not in registered_backends():
        raise ValueError(
            f"unknown backend {backend!r}; registered: "
            f"{registered_backends()}")
    runner = backend_on(backend, device, reps=reps, dtype=dtype, seed=seed)
    if not getattr(runner, "supports_tuning", False):
        raise ValueError(
            f"backend {backend!r} has no tunable kernel parameters; "
            f"--tune requires a tuning-capable backend (cuda)")
    from ..kernels.autotune import autotune, default_tune_requests
    from .tuning import save_tuning_table
    dims = GRIDS[grid]
    requests = default_tune_requests(grid_calls(dims), fused_dims=dims)
    fp = runner.fingerprint()
    t0 = time.perf_counter()
    table = autotune(runner, requests, reps=reps, budget=budget,
                     progress=progress)
    wall = time.perf_counter() - t0
    path = None
    if save:
        meta = {"grid": grid, "reps": reps, "budget": budget,
                "wall_s": round(wall, 3)}
        path = save_tuning_table(table, fp, directory=out, meta=meta)
    return TuneResult(table=table, fingerprint=fp, path=path, wall_s=wall,
                      n_requests=len(requests))


def main(argv: Optional[List[str]] = None) -> int:
    from .cli_help import (analysis_rules_epilog, backends_epilog,
                           discriminants_epilog)
    register_torch_backends()
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.calibrate",
        description="Calibrate this machine's kernel performance profile "
                    "on the PyTorch port.",
        epilog=backends_epilog() + "\n\n" + discriminants_epilog()
               + "\n\n" + analysis_rules_epilog(),
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--backend", choices=registered_backends(),
                    default="cuda",
                    help="execution backend to calibrate (the registry "
                         "key is also the profile fingerprint key)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu, "
                         "where the kernels' plain versions run; blas and "
                         "numpy run on the host and ignore it")
    ap.add_argument("--expr", default=None,
                    help="calibrate only the kernel calls of one registered "
                         "expression family (see `python -m "
                         "repro_torch.core.sweep --list-exprs`); --grid "
                         "then names a sweep grid")
    ap.add_argument("--grid", default="default",
                    help=f"calibration grid {sorted(GRIDS)}, or with "
                         "--expr a sweep grid name or comma-separated "
                         "axis values")
    ap.add_argument("--reps", type=int, default=3,
                    help="timing repetitions per kernel call")
    ap.add_argument("--out", type=Path, default=None,
                    help="output directory (default: $REPRO_PROFILE_DIR "
                         "or ~/.cache/repro/profiles, where the sweep's "
                         "predict and evaluate modes look)")
    ap.add_argument("--dtype", default=None,
                    help="dtype to measure in, the fingerprint's label "
                         "(default: the backend's own: float64 for blas "
                         "and numpy, float32 for torch and cuda; torch "
                         "also takes float64, bfloat16 and float16)")
    ap.add_argument("--tune", action="store_true",
                    help="autotune the kernels' launches instead of "
                         "measuring a kernel profile: prune each kernel's "
                         "launch candidates by shared memory and its cost "
                         "model, time the survivors, persist the winners "
                         "as a TuningTable the cuda backend auto-loads")
    ap.add_argument("--tune-budget", type=int, default=8,
                    help="with --tune: max candidate launches timed per "
                         "(kind, dims) request after pruning")
    ap.add_argument("--seed", type=int, default=None,
                    help="operand-synthesis seed: benchmark operands "
                         "become pure functions of (seed, base, shape), "
                         "so repeat calibrations time identical inputs")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    dtypes = get_backend_class(args.backend).dtypes
    if args.dtype is not None and dtypes is not None \
            and args.dtype not in dtypes:
        # Before anything is built: a label the backend does not measure
        # would stamp a fingerprint its measurements do not match.
        ap.error(f"backend {args.backend!r} measures {'/'.join(dtypes)}; "
                 f"got --dtype {args.dtype}")

    if args.tune:
        if args.expr is not None:
            ap.error("--tune and --expr are mutually exclusive")

        def tune_progress(i, n, kind, dims, entry):
            if not args.quiet:
                speedup = entry.default_seconds / max(entry.seconds, 1e-12)
                print(f"  [{i}/{n}] {kind}{dims} -> {entry.config} "
                      f"({entry.timed} timed, {entry.pruned} pruned, "
                      f"{speedup:.2f}x vs the model's pick)",
                      file=sys.stderr)

        res = tune(backend=args.backend, grid=args.grid, reps=args.reps,
                   out=args.out, dtype=args.dtype,
                   budget=args.tune_budget, progress=tune_progress,
                   seed=args.seed, device=args.device)
        print(f"tuned {res.n_requests} kernel shapes on "
              f"{res.fingerprint.backend}/{res.fingerprint.device}"
              f"/{res.fingerprint.dtype} in {res.wall_s:.1f}s")
        print(f"tuning table written to {res.path}")
        return 0

    def progress(i: int, n: int, call: KernelCall, seconds: float):
        if not args.quiet and (i % 25 == 0 or i == n):
            print(f"  [{i}/{n}] {call} {seconds * 1e6:.1f}us",
                  file=sys.stderr)

    res = calibrate(backend=args.backend, grid=args.grid, reps=args.reps,
                    out=args.out, dtype=args.dtype, progress=progress,
                    expr=args.expr, seed=args.seed, device=args.device)
    print(f"calibrated {res.n_calls} kernel shapes on "
          f"{res.fingerprint.backend}/{res.fingerprint.device}"
          f"/{res.fingerprint.dtype} in {res.wall_s:.1f}s "
          f"(peak ≈ {res.profile.peak() / 1e9:.1f} GFLOP/s)")
    print(f"profile written to {res.path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
