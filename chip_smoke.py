#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version at a main-path
   shape and at a ragged shape with transposed-view inputs, and time it
   beside its plain version, one PyTorch call of the same function
   (``library_ms``) and the card's bound for the same work;
4. run the paper's measured anomaly sweep — ``aatb`` over
   (400, 800, 1200)³ and ``abcd`` over (400, 1200)⁵ — on the ``cuda``
   backend into a temporary atlas, with every kernel's launch count set
   to 0 just before and read just after; then resume it (``measured=0``)
   and check every algorithm of both families against the plain
   ``torch`` backend on the same operands.

The last two lines are the card's ``nvidia-smi`` name/power line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 rate.
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

SEED = 0
REPS = 3
#: (name, axis values): the paper-scale grids the sweep phase covers.
SWEEPS = (("aatb", (400, 800, 1200)), ("abcd", (400, 1200)))

#: Kernel -> (source, the TPU kernel it replaces).
KERNEL_SOURCES = {
    "gemm": ("src/repro_torch/kernels/csrc/gemm.cu",
             "src/repro/kernels/gemm.py:40"),
    "syrk": ("src/repro_torch/kernels/csrc/syrk.cu",
             "src/repro/kernels/syrk.py:57"),
    "symm": ("src/repro_torch/kernels/csrc/symm.cu",
             "src/repro/kernels/symm.py:54"),
    "chain_gemm": ("src/repro_torch/kernels/csrc/chain_gemm.cu",
                   "src/repro/kernels/chain_gemm.py:64"),
}

#: Element-wise tolerance |kernel - plain| <= atol + rtol·|plain| (float32
#: sums in another order; the chain's second contraction runs over values
#: ~30x larger and its atomics add in a varying order, hence its atol).
TOL = {"gemm": (1e-4, 1e-3), "syrk": (1e-4, 1e-3), "symm": (1e-4, 1e-3),
       "chain_gemm": (1e-4, 1e-2)}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events, warm-up excluded).

    The inputs stay resident in the 50 MB L2 between calls, as they do
    between the repetitions of a sweep.
    """
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound(flops: int, nbytes: int):
    """Least time (ms) the card could take, and what bounds it."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def kernel_cases(torch, rng):
    """(kernel, label, kernel call, plain call, library call, flops, bytes)
    at a main-path shape and at a ragged one with transposed views."""
    from repro_torch.kernels import ops, ref

    def mat(r, c):
        return torch.from_numpy(rng.standard_normal((r, c))).float().cuda()

    def lower_with_garbage(m):
        s = rng.standard_normal((m, m))
        low = torch.from_numpy(s + s.T).float().cuda()
        garbage = torch.from_numpy(
            rng.standard_normal((m, m)) * 1e3).float().cuda()
        return torch.tril(low) + torch.triu(garbage, 1)

    f = 4  # bytes per float32
    cases = []
    # gemm: A·Aᵀ-sized main-path product; ragged with A as a transposed view.
    for label, (m, k, n), a in (
            ("1200x400x1200", (1200, 400, 1200), None),
            ("1100x333x1037, A=Xᵀ view", (1100, 333, 1037), "t")):
        A = mat(k, m).mT if a == "t" else mat(m, k)
        B = mat(k, n)
        cases.append(("gemm", label, lambda A=A, B=B: ops.gemm(A, B),
                      lambda A=A, B=B: ref.gemm(A, B),
                      lambda A=A, B=B: torch.mm(A, B),
                      2 * m * n * k, f * (m * k + k * n + m * n)))
    for label, (m, k) in (("1200x800", (1200, 800)), ("1100x333", (1100, 333))):
        A = mat(m, k)
        cases.append(("syrk", label, lambda A=A: ops.syrk(A),
                      lambda A=A: ref.syrk(A),
                      lambda A=A: torch.tril(torch.mm(A, A.mT)),
                      (m + 1) * m * k, f * (m * k + m * m)))
    # symm: garbage above S's diagonal; ragged as side R, B·S = (S·Bᵀ)ᵀ.
    for label, (m, n), side_r in (
            ("1200x400, garbage above diag", (1200, 400), False),
            ("1100x333 side R, B=Yᵀ view, garbage above diag", (1100, 333),
             True)):
        S = lower_with_garbage(m)
        if side_r:   # B·S = (S·Bᵀ)ᵀ, with Bᵀ a strided view
            Y = mat(n, m)
            run = lambda S=S, Y=Y: ops.symm(S, Y.mT).mT
            plain = lambda S=S, Y=Y: Y @ ref.tri2full(S)
            library = lambda S=S, Y=Y: torch.mm(
                Y, torch.tril(S) + torch.tril(S, -1).mT)
        else:
            B = mat(m, n)
            run = lambda S=S, B=B: ops.symm(S, B)
            plain = lambda S=S, B=B: ref.symm(S, B)
            library = lambda S=S, B=B: torch.mm(
                torch.tril(S) + torch.tril(S, -1).mT, B)
        cases.append(("symm", label, run, plain, library, 2 * m * m * n,
                      f * (m * (m + 1) // 2 + 2 * m * n)))
    for label, (m, k, l, n) in (("1200*800*1200*400", (1200, 800, 1200, 400)),
                                ("1100*333*1037*555", (1100, 333, 1037, 555))):
        A, B, C = mat(m, k), mat(k, l), mat(l, n)
        cases.append(("chain_gemm", label,
                      lambda A=A, B=B, C=C: ops.chain_gemm(A, B, C),
                      lambda A=A, B=B, C=C: ref.chain_gemm(A, B, C),
                      lambda A=A, B=B, C=C: torch.mm(torch.mm(A, B), C),
                      2 * m * k * l + 2 * m * l * n,
                      f * (m * k + k * l + l * n + m * n)))
    return cases


def check_kernels(torch, np) -> dict:
    """Phase 3: every kernel against its plain version, plus timings."""
    rng = np.random.default_rng(SEED)
    results = {}
    for name, label, run, plain, library, flops, nbytes in kernel_cases(
            torch, rng):
        out, expect = run(), plain()
        torch.cuda.synchronize()
        if out.shape != expect.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name} [{label}]: bad output "
                                 f"{tuple(out.shape)} vs {tuple(expect.shape)}")
        rtol, atol = TOL[name]
        diff = (out - expect).abs()
        max_abs = float(diff.max())
        rel = max_abs / float(expect.abs().max())
        ok = bool((diff <= atol + rtol * expect.abs()).all())
        ms, plain_ms, lib_ms = (time_ms(torch, run), time_ms(torch, plain),
                                time_ms(torch, library))
        b_ms, b_by = bound(flops, nbytes)
        print(f"{name:10s} [{label}]: max_abs_err={max_abs:.3e} "
              f"rel_err={rel:.3e} (tol rtol={rtol:g} atol={atol:g}) "
              f"{'ok' if ok else 'FAIL'}; ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"GFLOP/s={flops / ms / 1e6:.0f}")
        if not ok:
            raise AssertionError(f"{name} [{label}] disagrees with its plain "
                                 f"version beyond tolerance")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], max_abs)
        if "ms" not in r:   # the first case of each kernel is its main-path shape
            r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=b_ms, bound_by=b_by, shape=label)
    return results


def run_sweeps(torch, atlas_dir: Path):
    """Phase 4: the measured anomaly sweep on the ``cuda`` backend."""
    from repro_torch.core.backends import get_backend, register_torch_backends
    from repro_torch.core.expressions import GridSpec, get_spec
    from repro_torch.core.sweep import AnomalyAtlas, atlas_path, cluster_sweep, sweep
    from repro_torch.core.anomaly import region_summary
    from repro_torch.kernels import ops

    register_torch_backends()
    runner = get_backend("cuda", reps=REPS, seed=SEED)
    fp = runner.fingerprint()
    print(f"sweep fingerprint: {fp.to_dict()}")

    def atlas_for(spec):
        return AnomalyAtlas(atlas_path(spec.name, fp, 0.10, atlas_dir), fp,
                            spec.name, 0.10)

    grids = {}
    ops.reset_launch_counts()
    for name, axis in SWEEPS:
        spec = get_spec(name)
        grid = GridSpec.uniform(axis, spec.ndims, name=f"{axis}")
        grids[name] = (spec, grid)
        res = sweep(spec, grid.points(), runner=runner, atlas=atlas_for(spec))
        n_algos = len(spec.algorithms(grid.points()[0]))
        print(f"sweep {spec.name} over {axis}^{spec.ndims}: points="
              f"{res.n_points} x {n_algos} algorithms measured="
              f"{res.n_measured} skipped={res.n_skipped} anomalies="
              f"{len(res.anomalies)} ({res.anomaly_rate:.1%}) in "
              f"{res.wall_s:.1f}s")
        print(region_summary(cluster_sweep(res.records, grid), res.n_points))
        if res.n_points != grid.n_points or res.n_measured != grid.n_points:
            raise AssertionError(f"{name}: sweep measured {res.n_measured} of "
                                 f"{grid.n_points} points")
        for r in res.records:
            if not all(t > 0 and t == t for t in r.times.values()) or \
                    len(r.times) != n_algos:
                raise AssertionError(f"{name} {r.point}: bad times {r.times}")
    launches = ops.launch_counts()
    print("sweep kernel launches: " + " ".join(
        f"{k}={v}" for k, v in launches.items()))
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"the sweep never launched: {missing}")

    for name, (spec, grid) in grids.items():
        again = sweep(spec, grid.points(), runner=runner,
                      atlas=atlas_for(spec))
        print(f"resume {spec.name}: measured={again.n_measured} "
              f"skipped={again.n_skipped}")
        if again.n_measured != 0:
            raise AssertionError(f"{name}: resumed sweep re-measured points")
    return launches


def check_algorithms(torch):
    """Every algorithm of both families on the ``cuda`` backend against the
    plain ``torch`` backend on the same operands, at paper-scale points."""
    from repro_torch.core.backends import get_backend
    from repro_torch.core.expressions import get_spec

    cuda = get_backend("cuda", reps=1, seed=SEED)
    plain = get_backend("torch", reps=1, seed=SEED)
    for name, point in (("aatb", (1200, 800, 400)),
                        ("abcd", (400, 800, 1200, 600, 1000))):
        spec = get_spec(name)
        for alg in spec.algorithms(point):
            operands = cuda.make_operands(alg)
            got = cuda.execute(alg, operands)
            want = plain.execute(alg, operands)
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            print(f"algorithm {name}{point} {alg.name}: max_abs_err="
                  f"{err:.3e} (max |value| {scale:.3e})")
            if got.shape != want.shape or not bool(torch.isfinite(got).all()) \
                    or err > 1e-3 + 1e-4 * scale:
                raise AssertionError(f"{name} {alg.name} disagrees with the "
                                     f"plain torch backend")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    smi = nvidia_smi_line()
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f}s ({_build.library_path().name})")
    log = _build.library_path().with_suffix(".log")
    for line in log.read_text().splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"  ptxas {line.strip()}")

    results = check_kernels(torch, np)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-atlas-") as d:
        launches = run_sweeps(torch, Path(d))
    check_algorithms(torch)

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
