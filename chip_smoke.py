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
   (``library_ms``) and the card's bound for the same work, one call per
   event pair (``ms``) and ten back to back (``ms_b2b``); time the GEMM
   at the sweep's three shapes under the launch ``gemm_config`` picks,
   with blocks, waves over the SMs, TFLOP/s and share of bound; time SYMM
   (both sides) and the chain at their main-path shapes under the launches
   ``symm_config`` and ``chain_config`` pick, with blocks and waves,
   beside the port's ``ops.gemm`` on the same (m, m, n) product and the
   port's two ``ops.gemm`` calls the chain fuses; time SYRK and the fused
   GEMM+SYRK likewise under ``syrk_config`` and ``gemm_syrk_config``
   (blocks, clusters, ``cudaOccupancyMaxActiveClusters``, waves), beside
   the port's ``ops.gemm(A, A.mT)`` and its unfused
   ``ops.syrk(ops.gemm(A, B))``, with the flops the fused kernel executes
   against the paper's count;
4. run the paper's measured anomaly sweep — ``aatb`` over
   (400, 800, 1200)³, ``abcd`` over (400, 1200)⁵ and ``abab``, whose
   alg2 is the fused GEMM+SYRK, over (400, 800, 1200)³ — on the ``cuda``
   backend into a temporary atlas, with every kernel's launch count set
   to 0 just before and read just after (each must equal
   :data:`SWEEP_LAUNCHES`); then resume it (``measured=0``);
5. check every algorithm of all ten families against the plain ``torch``
   backend on the same operands, at one point each inside the paper's
   Experiment 1 box, and ``abab``'s alg2 once more with
   ``REPRO_NO_FUSION`` set (two kernels instead of one);
6. hold the flash-attention kernel against its plain version at Yi-9B's
   prefill shape (bf16, strided (B, S, H, D) views), a ragged float32
   non-causal shape, a gemma2-shaped bf16 window + soft-cap shape, a
   float32 MHA window + soft-cap shape and bf16 at every other head_dim
   of the tensor-core kernel, on logits sharp enough that the check
   rejects a planted fault (one key tile dropped), and time it beside its
   plain version, PyTorch's ``scaled_dot_product_attention`` and its
   bound;
7. serve Yi-9B at full width and depth in bf16 on random weights: prefill
   2 requests of 2048 tokens through ``api.prefill`` (the flash kernel
   in each of the 48 layers), decode 128 greedy tokens from that cache
   with ``api.decode_step``, prefill the 2176 tokens again, and hold the
   decode logits and tokens against the re-prefill's;
8. over phase 4's atlases, with a temporary ``REPRO_PROFILE_DIR``:
   calibrate the ``default`` kernel grid and then each family's calls on
   the ``cuda`` backend (gemm, syrk and symm must each launch
   1 + REPS times per timed call, nothing else), save, reload and require
   identical predictions, and print the host's work per call against the
   Hopper launch model; ``sweep --mode predict`` each family twice from an
   empty cache (the second must print ``measured=0``); ``sweep --mode
   evaluate`` with all six discriminants on the calibrated table
   (``measured`` must score top-1 100 % and zero regret, ``flops`` recall
   0), ``perfmodel`` under ``AnalyticalHopperProfile`` against ``flops``,
   and the measured / additive-model time of fused and unfused
   algorithms; Experiment 3 on aatb's records; Experiment 1 on aatb in
   the paper's box [20, 1200] (seed 0, 5 anomalies, at most 100 samples)
   and Experiment 2's line scans (step 40) through up to 2 of them.

The compiler's report must show no spills in any SYRK or GEMM+SYRK
instance. The last two lines are the card's ``nvidia-smi`` name/power
line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, dense BF16
#: on the tensor cores, HBM3 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

SEED = 0
REPS = 3
#: (name, axis values): the paper-scale grids the sweep phase covers.
SWEEPS = (("aatb", (400, 800, 1200)), ("abcd", (400, 1200)),
          ("abab", (400, 800, 1200)))
#: One point per family inside the paper's Experiment 1 box (dims <= 1200).
ALGORITHM_POINTS = (
    ("aatb", (1200, 800, 400)), ("abcd", (400, 800, 1200, 600, 1000)),
    ("abab", (1200, 400, 800)), ("abcde", (400, 800, 1200, 600, 1000, 500)),
    ("abtb", (1200, 800, 400)), ("atab", (1200, 400, 800)),
    ("btsb", (1200, 400)), ("decproj", (8, 1024, 1200)),
    ("decattn", (8, 1024, 128, 1200)), ("decmlp", (8, 1024, 1200)))

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
    "gemm_syrk": ("src/repro_torch/kernels/csrc/gemm_syrk.cu",
                  "src/repro/kernels/chain_gemm.py:142"),
    # The main path (bf16 prefill) runs the tensor-core kernel; float32
    # runs csrc/flash_attention.cu.
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                        "src/repro/kernels/flash_attention.py:89"),
}
#: Launches of each kernel in the sweep of phase 4: every kernel step of
#: every algorithm at every point of SWEEPS (``ab_bench.sweep_shapes``
#: walks them), each run 1 + REPS times. The served model (phase 7) runs
#: flash_attention.
SWEEP_LAUNCHES = {"gemm": 3656, "syrk": 648, "symm": 648, "chain_gemm": 1160,
                  "gemm_syrk": 108}

#: (rtol, atol). Element-wise |kernel - plain| <= atol + rtol·|plain|
#: (float32 sums in another order; the chain's second contraction runs
#: over values ~30x larger and its atomics add its l-chunks in a varying
#: order, hence its atol). gemm_syrk is held as check_algorithms holds an algorithm,
#: max|kernel - plain| <= atol + rtol·max|plain|: its diagonal is ~l·k
#: (3.2e5 at 1200·400·800) and entries off it ~sqrt(l)·k (1.1e4), so one
#: element-wise atol cannot fit both; float32 rounding of sums that large
#: is ~1e-7 of the largest value per term, and its atomics add the
#: l-chunks in a varying order.
TOL = {"gemm": (1e-4, 1e-3), "syrk": (1e-4, 1e-3), "symm": (1e-4, 1e-3),
       "chain_gemm": (1e-4, 1e-2), "gemm_syrk": (1e-5, 1e-2)}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(torch, fn, reps: int = 20, warmup: int = 3,
            inner: int = 1) -> float:
    """Median time of one call of ``fn`` in ms: CUDA events around
    ``inner`` calls, divided by ``inner``, warm-up excluded.

    With ``inner=1`` (every ``ms`` this script prints) the card is idle
    when the first event is recorded, so the time includes the host's
    work up to the launch: what one call, as the sweep makes it, costs. With
    ``inner=10`` (``ms_b2b``) the host enqueues the next call while the
    card runs this one, so a kernel longer than its wrapper's host work is
    timed alone. The inputs stay resident in the 50 MB L2 between calls,
    as they do between the repetitions of a sweep.
    """
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def bound(flops: int, nbytes: int, peak: float = PEAK_FP32_FLOPS):
    """Least time (ms) the card could take, and what bounds it."""
    t_ops = flops / peak * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def kernel_cases(torch, rng):
    """(kernel, label, kernel call, plain call, library call, flops, bytes
    [, flops the kernel executes where they differ]) at a main-path shape
    and at a ragged one with transposed views."""
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
    # gemm_syrk: abab alg2's pair at the paper's top corner; ragged with A
    # as a transposed view. The bound charges the paper's count of the pair.
    for label, (m, k, l), a in (
            ("1200·400·800", (1200, 400, 800), None),
            ("1100·333·1037, A=Xᵀ view", (1100, 333, 1037), "t")):
        A = mat(k, m).mT if a == "t" else mat(m, k)
        B = mat(k, l)

        def library(A=A, B=B):
            m1 = torch.mm(A, B)
            return torch.tril(torch.mm(m1, m1.mT))

        cases.append(("gemm_syrk", label,
                      lambda A=A, B=B: ops.gemm_syrk(A, B),
                      lambda A=A, B=B: ref.gemm_syrk(A, B), library,
                      2 * m * l * k + (m + 1) * m * l,
                      f * (m * k + k * l + m * m),
                      lambda m=m, k=k, l=l: gemm_syrk_executed_flops(
                          m, k, l)))
    return cases


def gemm_syrk_executed_flops(m: int, k: int, l: int) -> int:
    """Flops the gemm_syrk kernel executes under the launch its rule picks
    on this card, from the CPU schedule twin (kernels/gemm_syrk.py)."""
    from repro_torch.kernels import gemm_syrk as fused

    return fused.executed_flops(m, k, l, fused.gemm_syrk_config(
        m, k, l, fused.active_clusters(0)))


#: (m, k, n) of the GEMM timings: the main-path row of PERF.md and the
#: sweep's small shapes.
GEMM_SHAPES = ((1200, 400, 1200), (400, 1200, 400), (800, 800, 800))


def time_gemm_configs(torch, np) -> None:
    """Phase 3: the GEMM at the sweep's shapes under the launch
    ``gemm_config`` picks (``ab_bench.py`` times the other tiles)."""
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels import ops

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(SEED)
    for m, k, n in GEMM_SHAPES:
        a = torch.from_numpy(rng.standard_normal((m, k))).float().cuda()
        b = torch.from_numpy(rng.standard_normal((k, n))).float().cuda()
        cfg = gemm_mod.gemm_config(m, n, k, sms)
        flops = 2 * m * n * k
        b_ms, b_by = bound(flops, 4 * (m * k + k * n + m * n))
        ms = time_ms(torch, lambda: ops.gemm(a, b))
        ms_b2b = time_ms(torch, lambda: ops.gemm(a, b), inner=10)
        lib_ms = time_ms(torch, lambda: torch.mm(a, b))
        blocks = cfg.blocks(m, n)
        print(f"gemm {m}x{k}x{n} [{cfg.name}]: blocks={blocks} "
              f"waves={blocks / sms:.2f} ms={ms:.4f} ms_b2b={ms_b2b:.4f} "
              f"TFLOP/s={flops / ms / 1e9:.2f} (b2b "
              f"{flops / ms_b2b / 1e9:.2f}) bound_share={b_ms / ms:.1%} "
              f"({b_by}) library_ms={lib_ms:.4f} "
              f"ms/library_ms={ms / lib_ms:.2f}")


#: Main-path shapes of SYMM (m, n) and of the chain (m, k, l, n).
SYMM_SHAPE = (1200, 400)
CHAIN_SHAPE = (1200, 800, 1200, 400)


def time_symm_chain_configs(torch, np) -> None:
    """Phase 3: SYMM and the chain at their main-path shapes under the
    launches their rules pick, beside the port's GEMMs of the same work
    (``ab_bench.py`` times the other launches)."""
    from repro_torch.kernels import chain_gemm as chain_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import symm as symm_mod

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(SEED)

    def mat(r, c):
        return torch.from_numpy(rng.standard_normal((r, c))).float().cuda()

    m, n = SYMM_SHAPE
    s = torch.tril(mat(m, m)) + torch.triu(mat(m, m) * 1e3, 1)
    full = torch.tril(s) + torch.tril(s, -1).mT
    cfg = symm_mod.symm_config(m, n, sms)
    flops = 2 * m * m * n
    b_ms, _ = bound(flops, 4 * (m * (m + 1) // 2 + 2 * m * n))
    for side, b in (("L", mat(m, n)), ("R", mat(n, m).mT)):
        ms = time_ms(torch, lambda: ops.symm(s, b))
        ms_b2b = time_ms(torch, lambda: ops.symm(s, b), inner=10)
        g_ms = time_ms(torch, lambda: ops.gemm(full, b))
        g_b2b = time_ms(torch, lambda: ops.gemm(full, b), inner=10)
        blocks = cfg.blocks(m, n)
        print(f"symm {m}x{n} side {side} [{cfg.name}]: blocks={blocks} "
              f"waves={blocks / sms:.2f} ms={ms:.4f} ms_b2b={ms_b2b:.4f} "
              f"TFLOP/s={flops / ms / 1e9:.2f} (b2b "
              f"{flops / ms_b2b / 1e9:.2f}) bound_share={b_ms / ms:.1%}; "
              f"ops.gemm {m}x{m}x{n} ms={g_ms:.4f} ms_b2b={g_b2b:.4f}; "
              f"b2b symm/gemm={ms_b2b / g_b2b:.3f}")

    m, k, l, n = CHAIN_SHAPE
    a, b, c = mat(m, k), mat(k, l), mat(l, n)
    cfg = chain_mod.chain_config(m, k, l, n, sms)
    flops = 2 * m * k * l + 2 * m * l * n
    b_ms, _ = bound(flops, 4 * (m * k + k * l + l * n + m * n))
    run = lambda: ops.chain_gemm(a, b, c)
    two = lambda: ops.gemm(ops.gemm(a, b), c)
    ms, ms_b2b = time_ms(torch, run), time_ms(torch, run, inner=10)
    g_ms, g_b2b = time_ms(torch, two), time_ms(torch, two, inner=10)
    blocks = cfg.blocks(m, l)
    print(f"chain_gemm {m}*{k}*{l}*{n} [{cfg.name}, atomic sum of "
          f"{cfg.chunks(l)} l-chunks]: blocks={blocks} "
          f"waves={blocks / sms:.2f} ms={ms:.4f} ms_b2b={ms_b2b:.4f} "
          f"TFLOP/s={flops / ms / 1e9:.2f} (b2b {flops / ms_b2b / 1e9:.2f}) "
          f"bound_share={b_ms / ms:.1%}; two ops.gemm ms={g_ms:.4f} "
          f"ms_b2b={g_b2b:.4f}; b2b chain/two gemms={ms_b2b / g_b2b:.3f}")


#: Main-path shapes of SYRK (m, k) and of the fused GEMM+SYRK (m, k, l).
SYRK_SHAPE = (1200, 800)
GEMM_SYRK_SHAPE = (1200, 400, 800)


def time_syrk_gemm_syrk_configs(torch, np) -> None:
    """Phase 3: SYRK and the fused GEMM+SYRK at their main-path shapes
    under the launches their rules pick, beside the port's GEMM of the
    whole square and its unfused pair (``ab_bench.py`` times the other
    launches)."""
    from repro_torch.kernels import gemm_syrk as fused_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import syrk as syrk_mod

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(SEED)

    def mat(r, c):
        return torch.from_numpy(rng.standard_normal((r, c))).float().cuda()

    m, k = SYRK_SHAPE
    a = mat(m, k)
    cfg = syrk_mod.syrk_config(m, k, sms)
    flops = (m + 1) * m * k
    b_ms, _ = bound(flops, 4 * (m * k + m * m))
    run, square = lambda: ops.syrk(a), lambda: ops.gemm(a, a.mT)
    ms, ms_b2b = time_ms(torch, run), time_ms(torch, run, inner=10)
    g_ms, g_b2b = time_ms(torch, square), time_ms(torch, square, inner=10)
    blocks = syrk_mod.tiles(m, cfg.bm) * cfg.split
    print(f"syrk {m}x{k} [{cfg.name}]: blocks={blocks} "
          f"waves={blocks / sms:.2f} ms={ms:.4f} ms_b2b={ms_b2b:.4f} "
          f"TFLOP/s={flops / ms / 1e9:.2f} (b2b {flops / ms_b2b / 1e9:.2f}) "
          f"bound_share={b_ms / ms:.1%} (b2b {b_ms / ms_b2b:.1%}); ops.gemm "
          f"{m}x{k}x{m} ms={g_ms:.4f} ms_b2b={g_b2b:.4f}; b2b syrk/gemm="
          f"{ms_b2b / g_b2b:.3f}")

    m, k, l = GEMM_SYRK_SHAPE
    a, b = mat(m, k), mat(k, l)
    active = fused_mod.active_clusters(0)
    cfg = fused_mod.gemm_syrk_config(m, k, l, active)
    flops = 2 * m * k * l + (m + 1) * m * l
    executed = fused_mod.executed_flops(m, k, l, cfg)
    b_ms, _ = bound(flops, 4 * (m * k + k * l + m * m))
    run, pair = lambda: ops.gemm_syrk(a, b), lambda: ops.syrk(ops.gemm(a, b))
    ms, ms_b2b = time_ms(torch, run), time_ms(torch, run, inner=10)
    p_ms, p_b2b = time_ms(torch, pair), time_ms(torch, pair, inner=10)
    resident = fused_mod.max_active_clusters(m, cfg)
    print(f"gemm_syrk resident clusters of 1..8 CTAs: {active} (the rule's "
          f"table: {fused_mod.ACTIVE_CLUSTERS})")
    print(f"gemm_syrk {m}*{k}*{l} [{cfg.name}: l-chunks of {cfg.bl}, "
          f"clusters of {cfg.cluster} CTAs, {cfg.smem_bytes(m)} B shared "
          f"memory each]: blocks={cfg.blocks(l)} clusters={cfg.chunks(l)} "
          f"max_active_clusters={resident} "
          f"waves={cfg.chunks(l) / resident:.2f} "
          f"ms={ms:.4f} ms_b2b={ms_b2b:.4f} TFLOP/s={flops / ms / 1e9:.2f} "
          f"(b2b {flops / ms_b2b / 1e9:.2f}) bound_share={b_ms / ms:.1%} "
          f"(b2b {b_ms / ms_b2b:.1%}); ops.syrk(ops.gemm) ms={p_ms:.4f} "
          f"ms_b2b={p_b2b:.4f}; b2b fused/unfused={ms_b2b / p_b2b:.3f}; "
          f"executed_GFLOP={executed / 1e9:.3f} paper_GFLOP="
          f"{flops / 1e9:.3f} executed/paper={executed / flops:.3f}")


def check_kernels(torch, np) -> dict:
    """Phase 3: every kernel against its plain version, plus timings."""
    rng = np.random.default_rng(SEED)
    results = {}
    for name, label, run, plain, library, flops, nbytes, *extra in \
            kernel_cases(torch, rng):
        executed = extra[0]() if extra else None
        out, expect = run(), plain()
        torch.cuda.synchronize()
        if out.shape != expect.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name} [{label}]: bad output "
                                 f"{tuple(out.shape)} vs {tuple(expect.shape)}")
        rtol, atol = TOL[name]
        diff = (out - expect).abs()
        max_abs = float(diff.max())
        scale = float(expect.abs().max())
        rel = max_abs / scale
        if name == "gemm_syrk":
            ok = max_abs <= atol + rtol * scale
        else:
            ok = bool((diff <= atol + rtol * expect.abs()).all())
        # A tolerance would let small entries above the diagonal pass, and
        # the triangular kernels must leave them exactly zero.
        if name in ("syrk", "gemm_syrk") and \
                bool((torch.triu(out, 1) != 0).any()):
            raise AssertionError(f"{name} [{label}]: nonzero entries above "
                                 f"the diagonal")
        ms, plain_ms, lib_ms = (time_ms(torch, run), time_ms(torch, plain),
                                time_ms(torch, library))
        ms_b2b = time_ms(torch, run, inner=10)
        plain_b2b = time_ms(torch, plain, inner=10)
        b_ms, b_by = bound(flops, nbytes)
        print(f"{name:10s} [{label}]: max_abs_err={max_abs:.3e} "
              f"rel_err={rel:.3e} (tol rtol={rtol:g} atol={atol:g}) "
              f"{'ok' if ok else 'FAIL'}; ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"GFLOP/s={flops / ms / 1e6:.0f} ms/plain_ms={ms / plain_ms:.3f}"
              f"; b2b ms={ms_b2b:.4f} plain_ms={plain_b2b:.4f} "
              f"ms/plain_ms={ms_b2b / plain_b2b:.3f}"
              + (f" executed_GFLOP={executed / 1e9:.3f}" if executed else ""))
        if not ok:
            raise AssertionError(f"{name} [{label}] disagrees with its plain "
                                 f"version beyond tolerance")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], max_abs)
        if "ms" not in r:   # the first case of each kernel is its main-path shape
            r.update(ms=ms, ms_b2b=ms_b2b, plain_ms=plain_ms,
                     library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                     shape=label)
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
    wrong = {k: launches[k] for k, n in SWEEP_LAUNCHES.items()
             if launches[k] != n}
    if wrong:
        raise AssertionError(f"the sweep launched {wrong}, not "
                             f"{ {k: SWEEP_LAUNCHES[k] for k in wrong} }")

    for name, (spec, grid) in grids.items():
        again = sweep(spec, grid.points(), runner=runner,
                      atlas=atlas_for(spec))
        print(f"resume {spec.name}: measured={again.n_measured} "
              f"skipped={again.n_skipped}")
        if again.n_measured != 0:
            raise AssertionError(f"{name}: resumed sweep re-measured points")
    return launches


def _agree(torch, label: str, got, want) -> None:
    """max|got - want| <= 1e-3 + 1e-4·max|want|, finite, same shape."""
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    print(f"algorithm {label}: max_abs_err={err:.3e} "
          f"(max |value| {scale:.3e})")
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) \
            or err > 1e-3 + 1e-4 * scale:
        raise AssertionError(f"{label} disagrees with the plain torch backend")


def check_algorithms(torch):
    """Phase 5: every algorithm of every family on the ``cuda`` backend
    against the plain ``torch`` backend on the same operands, at one
    paper-scale point each; then abab's fused alg2 with fusion off."""
    from repro_torch.core.backends import get_backend
    from repro_torch.core.expressions import get_spec, registered_names
    from repro_torch.kernels import ops

    cuda = get_backend("cuda", reps=1, seed=SEED)
    plain = get_backend("torch", reps=1, seed=SEED)
    checked = [name for name, _ in ALGORITHM_POINTS]
    if sorted(checked) != registered_names():
        raise AssertionError(f"families checked {sorted(checked)} are not "
                             f"the registry's {registered_names()}")
    for name, point in ALGORITHM_POINTS:
        for alg in get_spec(name).algorithms(point):
            operands = cuda.make_operands(alg)
            _agree(torch, f"{name}{point} {alg.name}",
                   cuda.execute(alg, operands), plain.execute(alg, operands))

    point = dict(ALGORITHM_POINTS)["abab"]
    (alg,) = [a for a in get_spec("abab").algorithms(point)
              if a.name == "alg2[gemm+syrk+tri2full]"]
    operands = cuda.make_operands(alg)
    ops.reset_launch_counts()
    fused = cuda.execute(alg, operands)
    fused_launches = ops.launch_counts()
    os.environ["REPRO_NO_FUSION"] = "1"
    try:
        ops.reset_launch_counts()
        unfused = cuda.execute(alg, operands)
        unfused_launches = ops.launch_counts()
    finally:
        del os.environ["REPRO_NO_FUSION"]
    print(f"abab{point} alg2 launches: fused {fused_launches}, "
          f"REPRO_NO_FUSION {unfused_launches}")
    if fused_launches != dict.fromkeys(fused_launches, 0) | {"gemm_syrk": 1} \
            or unfused_launches != dict.fromkeys(unfused_launches, 0) | {
                "gemm": 1, "syrk": 1}:
        raise AssertionError("abab alg2 did not run as one gemm_syrk fused, "
                             "and as gemm + syrk without fusion")
    _agree(torch, f"abab{point} alg2 REPRO_NO_FUSION vs fused", unfused, fused)


#: Phase 6 cases: (label, B, H, Hkv, S, D, dtype, keyword arguments).
#: The first is the main path's shape: one Yi-9B prefill layer.
FLASH_CASES = (
    ("yi-9b prefill B2 H32/4 S2048 D128 bf16 causal", 2, 32, 4, 2048, 128,
     "bfloat16", dict(causal=True)),
    ("B1 H8/2 S1000 D96 f32 non-causal (ragged)", 1, 8, 2, 1000, 96,
     "float32", dict(causal=False)),
    ("gemma2 B1 H16/8 S1024 D256 bf16 window 512 softcap 50", 1, 16, 8,
     1024, 256, "bfloat16", dict(causal=True, window=512,
                                 logit_softcap=50.0)),
    ("B1 H4/4 S384 D64 f32 window 64 softcap 20", 1, 4, 4, 384, 64,
     "float32", dict(causal=True, window=64, logit_softcap=20.0)),
    # bf16 at the tensor-core kernel's other head dims (ragged S).
    ("B1 H8/2 S1000 D16 bf16 causal", 1, 8, 2, 1000, 16, "bfloat16",
     dict(causal=True)),
    ("B1 H8/2 S1000 D32 bf16 non-causal", 1, 8, 2, 1000, 32, "bfloat16",
     dict(causal=False)),
    ("B1 H8/8 S1000 D64 bf16 window 100", 1, 8, 8, 1000, 64, "bfloat16",
     dict(causal=True, window=100)),
    ("phi3 B1 H32/32 S1000 D96 bf16 causal", 1, 32, 32, 1000, 96,
     "bfloat16", dict(causal=True)),
)
#: (rtol, atol) by dtype, element-wise. Float32 sums in another order;
#: bfloat16 outputs are weighted means of values of magnitude ~1 (one ulp
#: at 1 is 2**-7), and kernel and plain version round p at different
#: points (before and after normalising) and the output once each.
FLASH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2 ** -6, 2 ** -6)}
#: Scale of q and k (v is standard normal): logits q·k/√D of standard
#: deviation QK_SCALE² ≈ 2.9, so each row's softmax puts most of its
#: weight on a few keys and outputs are O(1), as in trained attention.
#: At 0.3 (logits ~0.09) every row is near uniform, outputs ~1/√(q+1),
#: and a kernel that dropped a whole key tile could pass the bf16 check.
QK_SCALE = 1.7
#: Keys [lo, hi) of the planted fault: one 32-key tile of the main case,
#: hidden from every query past it, as a kernel that skipped one fully
#: visible tile would return. The check must reject it.
PLANTED_TILE = (1024, 1056)


def attention_heads(torch, rng, b, s, n, d, dtype, scale, device="cuda"):
    """A (B, S, n, D) buffer of standard normals times ``scale``, seen as
    the (B, n, S, D) view the model hands the kernel."""
    x = rng.standard_normal((b, s, n, d)) * scale
    return torch.from_numpy(x).to(dtype).to(device).transpose(1, 2)


def flash_close(out, expect, dtype: str):
    """(|out - expect| <= atol + rtol·|expect| everywhere, max|out - expect|)
    at :data:`FLASH_TOL`."""
    rtol, atol = FLASH_TOL[dtype]
    diff = (out.float() - expect.float()).abs()
    return (bool((diff <= atol + rtol * expect.float().abs()).all()),
            float(diff.max()))


def attention_hiding_keys(torch, q, k, v, lo: int, hi: int):
    """Causal attention as ``ref.flash_attention`` computes it, with keys
    [lo, hi) hidden from every query at or past ``hi``."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    kq = k.repeat_interleave(group, dim=1).float()
    vq = v.repeat_interleave(group, dim=1).float()
    logits = (q.float() @ kq.mT) * d ** -0.5
    i = torch.arange(s, device=q.device)
    hidden = (i[:, None] < i[None, :]) | (
        (i[None, :] >= lo) & (i[None, :] < hi) & (i[:, None] >= hi))
    p = torch.softmax(logits.masked_fill(hidden, float("-inf")), dim=-1)
    return (p.to(v.dtype).float() @ vq).to(q.dtype)


def attention_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible in one head: query q
    sees keys [max(0, q - window + 1), q] (causal) or up to s - 1."""
    w = window if 0 < window < s else s
    if causal:   # sum over q of min(q + 1, w)
        return w * (w + 1) // 2 + (s - w) * w
    return s * s - (s - w) * (s - w + 1) // 2


def check_flash(torch, np) -> dict:
    """Phase 6: the flash-attention kernel against its plain version."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED)
    result = {"max_abs_err": 0.0}
    for label, b, h, hkv, s, d, dtype, kw in FLASH_CASES:
        dt = getattr(torch, dtype)
        q, k, v = (attention_heads(torch, rng, b, s, n, d, dt, scale)
                   for n, scale in ((h, QK_SCALE), (hkv, QK_SCALE),
                                    (hkv, 1.0)))
        run = lambda: ops.flash_attention(q, k, v, **kw)
        plain = lambda: ref.flash_attention(q, k, v, **kw)
        out, expect = run(), plain()
        torch.cuda.synchronize()
        if out.shape != expect.shape or out.dtype != dt or \
                not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"flash_attention [{label}]: bad output")
        rtol, atol = FLASH_TOL[dtype]
        ok, max_abs = flash_close(out, expect, dtype)
        if "ms" not in result:   # the main case: a dropped tile must fail
            lo, hi = PLANTED_TILE
            passes, err = flash_close(
                out, attention_hiding_keys(torch, q, k, v, lo, hi), dtype)
            print(f"flash_attention [{label}] against a planted fault "
                  f"(keys [{lo}, {hi}) dropped past them): max_abs_err="
                  f"{err:.3e} {'ACCEPTED' if passes else 'rejected'}")
            if passes:
                raise AssertionError("the flash check cannot tell a kernel "
                                     "that drops a key tile")
        library = None
        if not kw.get("logit_softcap") and not kw.get("window"):
            library = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=kw["causal"], enable_gqa=True)
        ms, plain_ms = time_ms(torch, run), time_ms(torch, plain)
        ms_b2b = time_ms(torch, run, inner=10)
        lib_ms = time_ms(torch, library) if library else None
        pairs = attention_pairs(s, kw["causal"], kw.get("window", 0))
        flops = 4 * d * pairs * b * h
        nbytes = q.element_size() * (2 * b * h * s * d + 2 * b * hkv * s * d)
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS
                           if dtype == "bfloat16" else PEAK_FP32_FLOPS)
        print(f"flash_attention [{label}]: max_abs_err={max_abs:.3e} "
              f"(tol rtol={rtol:g} atol={atol:g}) {'ok' if ok else 'FAIL'}; "
              f"ms={ms:.4f} ms_b2b={ms_b2b:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={'n/a' if lib_ms is None else f'{lib_ms:.4f}'} "
              f"bound_ms={b_ms:.4f} ({b_by}) TFLOP/s={flops / ms / 1e9:.1f} "
              f"bound_share={b_ms / ms:.1%}"
              + ("" if lib_ms is None else f" ms/library_ms={ms / lib_ms:.2f}"))
        if not ok:
            raise AssertionError(f"flash_attention [{label}] disagrees with "
                                 f"its plain version beyond tolerance")
        result["max_abs_err"] = max(result["max_abs_err"], max_abs)
        if "ms" not in result:   # the first case is the main path's shape
            result.update(ms=ms, ms_b2b=ms_b2b, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                          shape=label)
    return result


#: Phase 7: requests, prompt tokens and greedy tokens of the served model.
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 2, 2048, 128
#: |decode logit - re-prefill logit| limit, in logit units (the random
#: model's logits have a standard deviation of ~1). Both paths run in
#: bfloat16 with the KV cache stored in bfloat16; they differ in where
#: they round (the flash kernel rounds p to bfloat16 before P·V, decode
#: keeps float32 probabilities) and in the GEMM shapes (one token against
#: 2176), so their hidden states drift apart by a few bfloat16 ulps per
#: layer over 48 layers.
DECODE_LOGIT_TOL = 0.5


def aten_calls_per_decode_step(torch, api, model, cfg, batch: int) -> int:
    """ATen operator calls one decode step dispatches (views included),
    counted on a scratch cache: the host-side work of an eager step."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    caches = api.init_caches(model, cfg, batch, 2)
    tokens = torch.zeros((batch, 1), dtype=torch.long, device="cuda")
    with Count() as count:
        api.decode_step(model, cfg, tokens, caches)
    return count.n


def serve_model(torch, np) -> dict:
    """Phase 7: Yi-9B at full width and depth on the card."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    from repro_torch.models import api

    cfg = configs.get("yi_9b")
    t0 = time.perf_counter()
    model = api.init(cfg, seed=SEED, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    # The config's analytic count leaves out the RMSNorm gains.
    n_norms = (2 * cfg.n_layers + 1) * cfg.d_model
    print(f"serve {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} head_dim {cfg.head_dim} "
          f"d_ff {cfg.d_ff} vocab {cfg.vocab}; {n_params} parameters "
          f"(config count {cfg.param_count()} + {n_norms} norm gains) in "
          f"bf16, init {time.perf_counter() - t0:.1f}s")
    if n_params != cfg.param_count() + n_norms:
        raise AssertionError("parameter count differs from the config's")
    b, s0, n_new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    max_s = s0 + n_new
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s0))).cuda()

    # Warm-up prefill (cuBLAS heuristics, allocator), not counted.
    api.prefill(model, cfg, {"tokens": prompt},
                api.init_caches(model, cfg, b, max_s))
    torch.cuda.synchronize()

    # The served path: counts from 0, the flash launches timed one by one.
    flash_events = []
    launch = flash_mod.flash_attention_cuda

    def timed_launch(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kw)
        end.record()
        flash_events.append((start, end))
        return out

    ops.reset_launch_counts()
    caches = api.init_caches(model, cfg, b, max_s)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    flash_mod.flash_attention_cuda = timed_launch
    try:
        start.record()
        logits, caches = api.prefill(model, cfg, {"tokens": prompt}, caches)
        end.record()
        torch.cuda.synchronize()
    finally:
        flash_mod.flash_attention_cuda = launch
    prefill_ms = start.elapsed_time(end)
    flash_ms = sum(a.elapsed_time(z) for a, z in flash_events)
    after_prefill = ops.launch_counts()
    print(f"prefill {b}x{s0}: {prefill_ms:.1f} ms, flash_attention "
          f"{flash_ms:.1f} ms in {len(flash_events)} launches "
          f"({flash_ms / prefill_ms:.1%} of prefill); launches "
          f"{after_prefill}")
    if after_prefill["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"prefill launched flash_attention "
                             f"{after_prefill['flash_attention']} times, "
                             f"not once per layer ({cfg.n_layers})")
    if logits.shape != (b, s0, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()) or caches.kv.length != s0:
        raise AssertionError("prefill: bad logits or cache length")

    # Greedy decode from the prefill's cache.
    last = logits[:, -1]
    tok = torch.argmax(last, dim=-1)[:, None]
    generated, decode_logits = [tok], []
    start.record()
    for _ in range(n_new):
        step_logits, caches = api.decode_step(model, cfg, tok, caches)
        decode_logits.append(step_logits[:, 0])
        tok = torch.argmax(step_logits[:, -1], dim=-1)[:, None]
        generated.append(tok)
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / n_new
    print(f"decode {n_new} tokens x {b} requests: {decode_ms:.2f} ms/token "
          f"({aten_calls_per_decode_step(torch, api, model, cfg, b)} ATen "
          f"calls a step); launches {ops.launch_counts()}")
    if ops.launch_counts() != after_prefill or caches.kv.length != max_s:
        raise AssertionError("decode launched a kernel or lost a token")

    # Re-prefill over prompt + the 128 tokens fed to decode.
    seq = torch.cat([prompt] + generated[:-1], dim=1)
    start.record()
    logits2, _ = api.prefill(model, cfg, {"tokens": seq},
                             api.init_caches(model, cfg, b, max_s))
    end.record()
    torch.cuda.synchronize()
    reprefill_ms = start.elapsed_time(end)
    launches = ops.launch_counts()
    print(f"re-prefill {b}x{max_s}: {reprefill_ms:.1f} ms; launches "
          f"{launches}")
    if launches["flash_attention"] != 2 * cfg.n_layers:
        raise AssertionError("re-prefill did not run flash_attention once "
                             "per layer")

    dec = torch.stack([last] + decode_logits, dim=1)           # (B, 129, V)
    ref_logits = logits2[:, s0 - 1:]                           # (B, 129, V)
    diff = (dec - ref_logits).abs()
    max_err, mean_err = float(diff.max()), float(diff.mean())
    top2 = torch.topk(ref_logits, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    chosen = torch.cat(generated, dim=1)                       # (B, 129)
    agree = chosen == torch.argmax(ref_logits, dim=-1)
    decided = margin > DECODE_LOGIT_TOL
    print(f"decode vs re-prefill logits over {dec.shape[1]} positions x "
          f"{b}: max|d|={max_err:.4f} mean|d|={mean_err:.5f} (tol "
          f"{DECODE_LOGIT_TOL}); logit std {float(ref_logits.std()):.3f}; "
          f"greedy tokens agree at {int(agree.sum())}/{agree.numel()}, at "
          f"{int((agree & decided).sum())}/{int(decided.sum())} where the "
          f"re-prefill's top-2 margin exceeds the tolerance")
    if not bool(torch.isfinite(dec).all()) or max_err > DECODE_LOGIT_TOL \
            or not bool(agree[decided].all()):
        raise AssertionError("decode disagrees with the re-prefill")
    return {"prefill_ms": prefill_ms, "flash_ms": flash_ms,
            "decode_ms_per_token": decode_ms, "reprefill_ms": reprefill_ms,
            "launches": launches}


#: Phase 8: the discriminants the evaluation scores, Experiment 1's search
#: (the paper's box, cut to 100 samples and 5 anomalies) and Experiment
#: 2's line scans (step 40, through at most 2 of those anomalies).
DISCRIMINANTS = ("flops", "perfmodel", "hybrid", "roofline", "measured",
                 "rankk")
EXPERIMENT1 = dict(box=(20, 1200), n_anomalies=5, max_samples=100, seed=0)
EXPERIMENT2_STEP, EXPERIMENT2_SCANS = 40, 2
#: Where phase 8 runs: the card (a rehearsal on the CPU sets "cpu").
DEVICE = "cuda"


def fused_pairs(alg) -> int:
    """Adjacent step pairs the ``cuda`` backend runs as one fused kernel
    (the walker's rule, ``walk_steps``)."""
    from repro_torch.core.backends import CudaOps, fusable_pattern

    fused, steps, i, n = CudaOps().fused_kinds(), alg.steps, 0, 0
    while i < len(steps) - 1:
        if fusable_pattern(steps[i], steps[i + 1], steps[i + 2:]) in fused:
            n, i = n + 1, i + 2
        else:
            i += 1
    return n


def run_cli(main, argv) -> str:
    """Run a CLI ``main`` in this process; its standard output, printed
    and returned. A non-zero exit raises."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    text = out.getvalue()
    print(text, end="")
    if rc != 0:
        raise AssertionError(f"{argv} exited {rc}")
    return text


def calibrate_predict_evaluate(atlas_dir: Path) -> dict:
    """Phase 8: calibrate, predict, evaluate and the paper's three
    experiments on the ``cuda`` backend, over phase 4's atlases."""
    import collections
    import statistics

    from repro_torch.core import calibrate as cal
    from repro_torch.core import sweep as sweep_mod
    from repro_torch.core.backends import get_backend
    from repro_torch.core.evaluate import evaluate_atlas, load_atlas_records
    from repro_torch.core.experiments import (
        experiment1_random_search, experiment2_regions,
        experiment3_predict_from_benchmarks)
    from repro_torch.core.expressions import get_spec
    from repro_torch.core.flops import KernelCall, gemm, symm, syrk, tri2full
    from repro_torch.core.perfmodel import (AnalyticalHopperProfile,
                                            predict_algorithm_time)
    from repro_torch.core.profile_store import (current_fingerprint,
                                                load_default_profile,
                                                load_profile)
    from repro_torch.kernels import ops

    grid_of = {name: ",".join(map(str, axis)) for name, axis in SWEEPS}
    calibrated_dir, predict_dir = atlas_dir / "profiles", atlas_dir / "predict"
    os.environ["REPRO_PROFILE_DIR"] = str(calibrated_dir)
    launches = collections.Counter()

    # 1. Calibrate the kernel space, then merge in each family's calls.
    ops.reset_launch_counts()
    timed = collections.Counter()
    t0 = time.perf_counter()
    res = cal.calibrate(backend="cuda", grid="default", reps=REPS, seed=SEED,
                        device=DEVICE)
    timed.update(c.kind for c in cal.grid_calls(cal.GRIDS["default"]))
    print(f"calibrate --grid default: {res.n_calls} calls in "
          f"{res.wall_s:.2f}s ({res.fingerprint.device})")
    family_calls = {}
    for name, _ in SWEEPS:
        calls = cal.expression_calls(get_spec(name), grid_of[name])
        family_calls[name] = calls
        res = cal.calibrate(backend="cuda", expr=name, grid=grid_of[name],
                            reps=REPS, seed=SEED, device=DEVICE)
        timed.update(c.kind for c in calls)
        print(f"calibrate --expr {name} --grid {grid_of[name]}: "
              f"{len(calls)} unique calls in {res.wall_s:.2f}s; the "
              f"profile holds {res.n_calls}")
    wall = time.perf_counter() - t0
    got = ops.launch_counts()
    launches.update(got)
    want = dict.fromkeys(got, 0) | {
        k: timed[k] * (1 + REPS) for k in ("gemm", "syrk", "symm")}
    print(f"calibrate: {sum(timed.values())} timed calls in {wall:.2f}s; "
          f"launches {got}")
    if got != want:
        raise AssertionError(f"calibrate launched {got}, not {want}")
    calibrated, fp = load_profile(res.path,
                                  expected_fingerprint=res.fingerprint)
    queries = [KernelCall(k, d) for k, d in res.profile.table] + [
        gemm(300, 700, 900), syrk(1500, 20), symm(77, 1100), tri2full(600)]
    if calibrated.table != res.profile.table or any(
            calibrated.time(c) != res.profile.time(c) for c in queries):
        raise AssertionError("the saved profile predicts other times")

    # The host's work per call: calibrated time minus the launch model's,
    # over the paper-scale calls the families make (dims 400-1200).
    hopper = AnalyticalHopperProfile()
    for kind in ("gemm", "syrk", "symm"):
        calls = {c for cs in family_calls.values() for c in cs
                 if c.kind == kind}
        rest = sorted(calibrated.time(c) - hopper.launch_time(c)
                      for c in calls)
        q = statistics.quantiles(rest, n=4)
        print(f"host overhead {kind}: median {statistics.median(rest):.4e} s "
              f"(quartiles {q[0]:.4e}, {q[2]:.4e}) over {len(rest)} calls; "
              f"the model charges {hopper.hw.kernel_overhead_s:.4e}")

    # 2. Predict each family from per-kernel timings, twice, from an
    # empty profile cache of its own.
    for name, _ in SWEEPS:
        os.environ["REPRO_PROFILE_DIR"] = str(predict_dir / name)
        for attempt in (1, 2):
            before = load_default_profile("cuda", "float32", DEVICE)
            new = collections.Counter(
                c.kind for c in dict.fromkeys(family_calls[name])
                if before is None or c not in before)
            ops.reset_launch_counts()
            text = run_cli(sweep_mod.main, [
                "--expr", name, "--grid", grid_of[name], "--mode",
                "predict", "--reps", str(REPS), "--seed", str(SEED),
                "--device", DEVICE, "--atlas-dir", str(atlas_dir),
                "--quiet"])
            got = ops.launch_counts()
            launches.update(got)
            want = dict.fromkeys(got, 0) | {
                k: new[k] * (1 + REPS) for k in ("gemm", "syrk", "symm")}
            m = re.search(r"measured=(\d+)", text)
            if got != want or int(m.group(1)) != sum(new.values()) or \
                    "vs atlas ground truth" not in text:
                raise AssertionError(f"predict {name} run {attempt}: "
                                     f"launches {got}, not {want}")
            if attempt == 2 and int(m.group(1)) != 0:
                raise AssertionError(f"predict {name} re-measured kernels")

    # 3. Evaluate all six discriminants on each phase-4 atlas, with the
    # calibrated table; perfmodel under the Hopper model against flops.
    os.environ["REPRO_PROFILE_DIR"] = str(calibrated_dir)
    fp = current_fingerprint("cuda", "float32", DEVICE)
    replays, scores = {}, {}
    for name, _ in SWEEPS:
        spec = get_spec(name)
        run_cli(sweep_mod.main, [
            "--expr", name, "--grid", grid_of[name], "--mode", "evaluate",
            "--discriminants", ",".join(DISCRIMINANTS), "--device", DEVICE,
            "--atlas-dir", str(atlas_dir), "--quiet"])
        replay = load_atlas_records(
            sweep_mod.atlas_path(spec.name, fp, 0.10, atlas_dir))
        replays[name] = replay
        res = evaluate_atlas(replay, DISCRIMINANTS, profile=calibrated)
        measured, flops = res.scores["measured"], res.scores["flops"]
        if measured.top1_accuracy != 1.0 or measured.mean_regret != 0.0 \
                or measured.p95_regret != 0.0:
            raise AssertionError(f"{name}: measured scored {measured.row()}")
        if res.n_anomalies and flops.recall != 0.0:
            raise AssertionError(f"{name}: flops predicted an anomaly")
        if any(s.error for s in res.scores.values()):
            raise AssertionError(f"{name}: a discriminant failed: "
                                 f"{res.summary()}")
        modeled = evaluate_atlas(replay, ["flops", "perfmodel"],
                                 profile=AnalyticalHopperProfile())
        print(f"Hopper model score, {spec.name}: perfmodel under "
              f"AnalyticalHopperProfile vs flops")
        for s in modeled.scores.values():
            print(f"  {s.row()}")
        scores[name] = {n: {"top1": s.top1_accuracy,
                            "mean_regret": s.mean_regret,
                            "recall": s.recall, "precision": s.precision}
                        for n, s in res.scores.items()}

        # The fusion gap: measured / additive-model time, by whether the
        # cuda backend fused a step pair of the algorithm.
        ratios = collections.defaultdict(list)
        for inst in replay.records:
            for alg in spec.algorithms(inst.point):
                model = predict_algorithm_time(alg.calls, calibrated, 4)
                ratios["fused" if fused_pairs(alg) else "unfused"].append(
                    inst.times[alg.name] / model)
        for group, r in sorted(ratios.items()):
            print(f"fusion gap {spec.name} {group}: measured/predicted "
                  f"median {statistics.median(r):.3f} (min {min(r):.3f}, "
                  f"max {max(r):.3f}) over {len(r)} algorithm timings")

    # 4. Experiment 3 on aatb's phase-4 records.
    spec = get_spec("aatb")
    classified = {r.point: r for r in replays["aatb"].records}
    ops.reset_launch_counts()
    e3 = experiment3_predict_from_benchmarks(spec, "cuda", classified,
                                             profile=calibrated,
                                             device=DEVICE)
    launches.update(ops.launch_counts())
    print(f"experiment 3 {spec.name} (threshold 0.05): measured="
          f"{e3.n_calls_measured} reused={e3.n_calls_reused}")
    print(e3.confusion.as_table())

    # 5-6. Experiments 1 and 2 on aatb, in the paper's box.
    runner = get_backend("cuda", reps=REPS, seed=SEED, device=DEVICE)
    ops.reset_launch_counts()
    e1 = experiment1_random_search(spec, runner, **EXPERIMENT1)
    e1_launches = ops.launch_counts()
    launches.update(e1_launches)
    print(f"experiment 1 {spec.name} in {EXPERIMENT1['box']}: samples="
          f"{e1.samples} anomalies={len(e1.anomalies)} (abundance "
          f"{e1.abundance:.1%}) in {e1.wall_s:.1f}s; launches {e1_launches}")
    for inst in e1.anomalies:
        print(f"  anomaly at {inst.point} ts={inst.cls.time_score:.1%} "
              f"fs={inst.cls.flop_score:.1%}")
    if e1.samples != EXPERIMENT1["max_samples"] and \
            len(e1.anomalies) < EXPERIMENT1["n_anomalies"]:
        raise AssertionError("experiment 1 stopped early")
    ops.reset_launch_counts()
    e2 = experiment2_regions(spec, runner,
                             e1.anomalies[:EXPERIMENT2_SCANS],
                             box=EXPERIMENT1["box"], step=EXPERIMENT2_STEP)
    launches.update(ops.launch_counts())
    print(f"experiment 2 {spec.name}: {len(e2.scans)} line scans, "
          f"{len(e2.classified)} points probed; launches "
          f"{ops.launch_counts()}")
    for scan in e2.scans:
        print(f"  scan dim {scan.dim} through {scan.origin}: region "
              f"[{scan.lo}, {scan.hi}] thickness {scan.thickness} over "
              f"{len(scan.points)} probes")
    if len(e2.scans) != spec.ndims * min(EXPERIMENT2_SCANS,
                                         len(e1.anomalies)):
        raise AssertionError("experiment 2 scanned the wrong lines")
    print(f"phase 8 kernel launches: {dict(launches)}")
    idle = [k for k in ("gemm", "syrk", "symm", "chain_gemm")
            if not launches[k]]
    if idle:
        raise AssertionError(f"phase 8 never launched {idle}")
    return {"launches": dict(launches), "scores": scores}


def print_ptxas_report(log: Path) -> dict:
    """Registers, shared memory and spills per kernel (``-Xptxas=-v``);
    the flash kernels' instantiations are named by type and head_dim, the
    GEMM's, SYMM's, the chain's and SYRK's by tile, the fused GEMM+SYRK's
    by chunk width. Returns the spill bytes (stores + loads) of each
    named instance."""
    name, spills = "", {}
    for line in log.read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            fn = entry.group(1)
            f32 = re.search(r"flash_kernelILi(\d+)E", fn)
            tc = re.search(r"flash_tc_kernelILi(\d+)E", fn)
            tiled = re.search(r"(gemm|symm|chain)_kernelILi(\d+)ELi(\d+)E", fn)
            square = re.search(r"\d+syrk_kernelILi(\d+)E", fn)
            fused = re.search(r"gemm_syrk_kernelILi(\d+)E", fn)
            name = (f"flash_kernel<f32,{f32.group(1)}> " if f32 else
                    f"flash_tc_kernel<bf16,{tc.group(1)}> " if tc else
                    f"{tiled.group(1)}_kernel<{tiled.group(2)}x"
                    f"{tiled.group(3)}> " if tiled else
                    f"syrk_kernel<{square.group(1)}x{square.group(1)}> "
                    if square else
                    f"gemm_syrk_kernel<bl{fused.group(1)}> " if fused else
                    "split_sum_kernel " if "split_sum_kernel" in fn else
                    "tril_sum_kernel " if "tril_sum_kernel" in fn else "")
        if line.startswith("=="):
            name = ""
            print(f"  ptxas {line.strip()}")
        elif "registers" in line or "spill" in line:
            text = line.replace("ptxas info    :", "").strip()
            print(f"  ptxas {name}{text}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if spill and name:
                spills[name.strip()] = spills.get(name.strip(), 0) + int(
                    spill.group(1)) + int(spill.group(2))
    return spills


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # The sweep's launch counts assume the default, fused dispatch.
    os.environ.pop("REPRO_NO_FUSION", None)
    from repro_torch.kernels import _build

    smi = nvidia_smi_line()
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs accumulate in float32 (no reduced-precision split-K).
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f}s ({_build.library_path().name})")
    spills = print_ptxas_report(_build.library_path().with_suffix(".log"))
    spilled = {k: v for k, v in spills.items() if "syrk" in k and v}
    if spilled or not any(k.startswith("gemm_syrk") for k in spills):
        raise AssertionError(f"SYRK / GEMM+SYRK instances spill: {spilled}")

    results = check_kernels(torch, np)
    time_gemm_configs(torch, np)
    time_symm_chain_configs(torch, np)
    time_syrk_gemm_syrk_configs(torch, np)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-atlas-") as d:
        launches = run_sweeps(torch, Path(d))
        check_algorithms(torch)
        results["flash_attention"] = check_flash(torch, np)
        served = serve_model(torch, np)
        launches["flash_attention"] = served["launches"]["flash_attention"]
        predicted = calibrate_predict_evaluate(Path(d))

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "ms_b2b": r["ms_b2b"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "launches_phase8": predicted["launches"].get(name, 0)})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
