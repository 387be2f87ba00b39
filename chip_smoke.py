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
   backend into a temporary atlas, each algorithm timed as one replayed
   CUDA graph, with the fast path on (operand arena, pipelined
   preparation; it prints the ``fastpath:`` counter line), every kernel's
   launch count set to 0 just before and read just after (each must equal
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
   :data:`EXECUTIONS` times per timed call, nothing else), save, reload
   and require identical predictions, and print what a graph-timed call
   costs beyond the Hopper launch model (``H100_SXM.kernel_overhead_s``);
   ``sweep --mode predict`` each family twice from an
   empty cache (the second must print ``measured=0``); ``sweep --mode
   evaluate`` with all six discriminants on the calibrated table
   (``measured`` must score top-1 100 % and zero regret, ``flops`` recall
   0), ``perfmodel`` under ``AnalyticalHopperProfile`` against ``flops``,
   and the measured / additive-model time of fused and unfused
   algorithms; Experiment 3 on aatb's records; Experiment 1 on aatb in
   the paper's box [20, 1200] (seed 0, 5 anomalies, at most 100 samples)
   and Experiment 2's line scans (step 40) through up to 2 of them;
9. the rest of the sweep engine: every algorithm of ``aatb`` at
   (1200, 800, 400) timed eagerly (the walk between synchronisations),
   as a replayed CUDA graph, and as the sum of its steps' back-to-back
   times (the host share of each); the sweep of ``aatb`` over
   (400, 800, 1200)³ again with ``--no-fastpath`` (the same points and
   the same launches as phase 4's); ``--compare-backends torch,cuda``
   over that grid; ``--mode adaptive`` on ``aatb`` in the paper's box at
   a step of 40, unsharded and as ``--shard 0/2`` + ``--shard 1/2``,
   merged by ``tools/atlas_merge.py`` and read back;
10. tuning and the planner, with a temporary ``REPRO_PROFILE_DIR``:
   ``calibrate --tune --grid default --tune-budget 8`` (per kind the
   requests, launches timed and pruned, the winners that differ from the
   launch rule's pick, model pick / winner seconds, wall time and peak
   reserved memory; every winner at most its model pick as measured, the
   saved table reloads equal, and the launches are exactly timed
   candidates × :data:`EXECUTIONS`); each kernel under up to 4 winners
   that differ from the model's pick against its plain version, and a
   table entry traced to the launch it makes; the sweeps of phase 4 with
   the table auto-loaded and with ``--no-tuning`` (phase 4's launches both
   ways, the anomaly counts both ways, and a resume under the other
   tuning state refused); ``PlanService`` on the ``cuda`` backend:
   ``lookup`` + ``execute`` of aatb, decmlp and decattn plans against the
   plain composition, a second lookup returns the same plan, refinement
   bumps the profile generation and the next lookup misses once, and the
   load test (2,000 requests over 8 threads, one enumeration per burst);
   Yi-9B again with ``plan_warmup``, prefill 2 × 2048 and 16 greedy
   tokens decoded twice from the same cache, with the consult on (plan
   cache hits = layers × tokens) and under ``REPRO_SERVE_PLANNER=0``: the
   same tokens;
11. the other decoder families, each at full width and depth in bf16 on
   random weights, one at a time: the flash kernel against its plain
   version at OLMoE's prefill shape (MHA, 16 heads of 128; the planted
   fault rejected); OLMoE-1B-7B prefills 2 × 2048 tokens (flash once in
   each of its 16 layers), decodes 32 greedy tokens with no kernel
   launch, holds ``moe.apply``'s gather dispatch against its einsum
   dispatch on layer 0's real input and prints decode against a
   re-prefill of 2080 (not gated: a decode step's expert capacity is 1);
   Mamba2-370M prints ``select_ssd_mode``'s picks, prefills 2 × 2048
   (chunked SSD), decodes 128 greedy tokens and holds them against a
   re-prefill of 2176, as phase 7; Zamba2-1.2B runs
   ``serve.decode.generate`` (a 2 × 128 prompt fed token by token, 32 new
   tokens) twice: the tokens must be identical and every logit finite.
   One prefill and one decode step of each (Zamba2: a step) run once more
   under ``torch.profiler``: host wall time, device time and the ATen
   ops and hand kernels that take the most device time;
12. the paper's own protocol beside the card's backends, on the host's
   CPU (its model and thread count printed beside every ``blas`` figure):
   (a) every algorithm of ``aatb`` at (1200, 800, 400) and of ``abcd`` at
   (400, 1200, 400, 1200, 400) on ``blas`` and ``numpy`` (float64, the
   host), ``torch`` on the card in float64 and bfloat16 and ``cuda``
   (float32), on the same seeded operands, each held against ``blas``
   (:data:`PROTOCOL_F64_TOL`, phase 5's limit for ``cuda``,
   :data:`PROTOCOL_BF16_TOL`); (b) ``sweep --compare-backends blas,cuda``
   over phase 4's ``aatb`` and ``abcd`` grids with the cache flush on,
   into a fresh atlas directory (the ``cuda`` launches must equal phase
   4's; the two fingerprints must differ); (c) ``calibrate --backend
   blas`` and ``--backend torch --dtype bfloat16`` on ``aatb``'s calls
   (host- and bfloat16-fingerprinted profiles), and ``--backend cuda
   --dtype bfloat16`` must exit non-zero; (d) Experiment 1 on ``aatb`` in
   [20, 600] (50 samples, seed 0) on ``blas`` serially and over two
   worker processes, and on ``cuda`` through the devices engine: the same
   50 points; then ``python -m repro_torch.benchmarks.experiment3`` at CI
   scale on ``cuda``, its recall and precision printed;
13. the encdec and vlm families: the flash kernel against its plain
   version at InternVL2-76B's prefill shape (GQA, 64 query heads over 8
   KV heads of 128, S 2048, bf16, causal; the planted fault rejected);
   InternVL2-76B at its published widths with its depth cut to 32 of 80
   layers (:data:`INTERNVL_LAYERS`), bf16, random weights: ``api.prefill``
   of 256 vision positions and 1792 tokens a request (flash once in each
   layer), 128 greedy tokens with no kernel launch, held against a
   re-prefill of 2176 positions as phase 7 holds Yi-9B's; whisper-tiny at
   its full size: the encoder over 1500 frames, ``serve.decode.generate``
   of a 64-token prompt fed token by token and 128 new tokens with the
   frames, twice (identical tokens, finite logits, no kernel launch), and
   its decode logits held against ``api.forward_train`` of the same
   tokens at phase 7's limit. A prefill and a decode step of InternVL2 run
   once more under ``torch.profiler``;
14. training, in bf16 on random weights from seed 0 and ``SyntheticLM``
   data from seed 0, with no hand-kernel launch: (a) the chunked
   attention with its own backward against autograd through the dense
   attention at Zamba2's shared-block shape (B 1, 32 heads of 64, S 2048,
   causal, window 4096), float32 and bf16, with both peaks of allocated
   memory (the chunked one must be lower) and a planted fault (one key
   block's dv dropped) rejected; (b) Mamba2-370M at full width and depth,
   2 × 2048 tokens a step, 12 AdamW steps through ``train_loop.train``
   (loss, lr, grad norm and ms per step, tokens/s, peak reserved memory,
   ``select_ssd_mode``'s pick; every loss finite and the last below the
   first) and one more step under ``torch.profiler``; (c) 6 Muon steps
   (``plan_ns_mode``'s pick and FLOPs per matrix shape, Newton–Schulz ms
   per step); (d) 8 steps saving every 4 (keep 1) with a crash at step 5
   under a ``Supervisor`` allowing one restart: each save's seconds and
   GB/s, the last save read back bit for bit, and the resumed steps'
   losses and final ``final_norm.g`` against an uninterrupted run;
   (e) Zamba2-1.2B at full width and depth, 1 × 2048 tokens, 4 AdamW
   steps at the reference launcher's default peak lr (3e-4), its shared
   block through the chunked attention at every application;
15. distribution, on a mesh of this one card and on fake process groups:
   (a) an NCCL world of one and ``make_host_mesh(model=1)``: Yi-9B at
   full width and depth in bf16 (phase 7's weights) first unsharded, then
   distributed by ``launch.specs.shard_model`` under
   ``activation_sharding``: prefill 2 × 2048 (flash exactly 48 launches,
   each on a rank's local heads) and 32 greedy tokens, the sharded tokens
   identical to the unsharded ones and the logits within
   :data:`DECODE_LOGIT_TOL`, prefill ms and ms/token both ways;
   (b) Mamba2-370M at full width, 2 × 2048 tokens, 4 AdamW steps through
   ``train_loop.train(mesh=...)``: the losses within
   :data:`SHARDED_LOSS_RTOL` of phase 14 (b)'s first four, step ms beside
   phase 14's, and the loop's checkpoint (specs and ``mesh_shape`` in its
   manifest) read back bit for bit; then the group is destroyed;
   (c) the dry-run, one process per cell on the host (started once (b)
   has destroyed its group, so that no tracing loads the host while (a)
   and (b) are timed): Yi-9B train_4k, prefill_32k and
   decode_32k, OLMoE-1B-7B and Arctic-480B train_4k on the (16, 16) mesh
   and Mamba2-370M train_4k on (2, 16, 16), each on a fake process group
   of 256 or 512 ranks: per-device peak bytes, FLOPs, collective bytes by
   kind, the roofline terms with the H100's figures, the bottleneck and
   the roofline fraction; the state's local bytes must equal those the
   specs give, and any cell's error fails the phase;
16. the batched path (the reference's vmap path): (a) each of the five
   matrix kernels on a batch of :data:`BATCHED_KERNEL_BATCH` instances in
   one launch, at phase 3's main-path shape and at a ragged shape with
   transposed-view (batched) inputs, each instance against its plain
   version at phase 3's tolerance, timed per launch and per instance (both
   methods) beside one batched ATen call (``torch.bmm`` or its
   expression) and the bound of the batch's work; (b) every algorithm of
   aatb, abcd and abab at :data:`BATCHED_POINTS` (a ``small``-grid point
   and the Experiment 1 points) on the ``cuda`` backend:
   ``execute_batch`` per instance against ``execute`` (phase 5's
   tolerance), and ``time_algorithm_batched`` (one replayed graph of the
   batched walk) per instance against ``time_algorithm`` at batch 1, 32
   and 256 (32 at the Experiment 1 points), each batched replay gated to
   launch exactly the algorithm's kernel steps, whatever the batch; the
   launches of (b) are counted from 0 (``launches_phase16``).

Multi-card runs are not made: NCCL refuses two ranks on one card, so the
layouts across ranks are checked by the gloo tests and the dry-run.

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
#: Executions of each kernel step per timed algorithm or call, on a graph
#: memo miss (``TorchBackend._timed_callable`` and
#: ``ExecutionBackend.time_algorithm``): one eager warm-up walk, then the
#: capture (which executes nothing; its counts are taken back), one
#: warm-up replay and REPS timed replays, each replay credited with the
#: launches its capture recorded. A sweep's algorithms never hit the
#: memo: its key holds the dims, and one point's algorithms differ in
#: structure.
EXECUTIONS = 2 + REPS
#: Kernel steps of the sweep of phase 4: every kernel step of every
#: algorithm at every point of SWEEPS (``ab_bench.sweep_shapes`` walks
#: them; phase 4 checks its counts against these), fused pairs as one.
SWEEP_STEPS = {"gemm": 914, "syrk": 162, "symm": 162, "chain_gemm": 290,
               "gemm_syrk": 27}
#: Launches of each kernel in the sweep of phase 4. The served models
#: (phases 7, 11 and 13) run flash_attention.
SWEEP_LAUNCHES = {k: n * EXECUTIONS for k, n in SWEEP_STEPS.items()}

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
        return torch.from_numpy(rng.standard_normal((r, c))).float().to(
            DEVICE)

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
        return torch.from_numpy(rng.standard_normal((r, c))).float().to(
            DEVICE)

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
        return torch.from_numpy(rng.standard_normal((r, c))).float().to(
            DEVICE)

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
    """Phase 4: the measured anomaly sweep on the ``cuda`` backend,
    graph-timed, with the fast path on. Returns the launches in all and
    by family."""
    from repro_torch.core.backends import get_backend, register_torch_backends
    from repro_torch.core.expressions import GridSpec, get_spec
    from repro_torch.core.sweep import AnomalyAtlas, atlas_path, cluster_sweep, sweep
    from repro_torch.core.anomaly import region_summary
    from repro_torch.kernels import ops

    import ab_bench

    register_torch_backends()
    runner = get_backend("cuda", reps=REPS, seed=SEED)
    fp = runner.fingerprint()
    print(f"sweep fingerprint: {fp.to_dict()}; timing {runner.timing}")
    if runner.timing != "graph":
        raise AssertionError("the cuda backend does not time CUDA graphs")
    steps = ab_bench.sweep_shapes()
    walked = {k: sum(sum(c.values()) for c in steps[k].values())
              for k in SWEEP_STEPS}
    if walked != SWEEP_STEPS:
        raise AssertionError(f"the sweep walks {walked} kernel steps, not "
                             f"{SWEEP_STEPS}")

    def atlas_for(spec):
        return AnomalyAtlas(atlas_path(spec.name, fp, 0.10, atlas_dir), fp,
                            spec.name, 0.10)

    grids, by_family = {}, {}
    ops.reset_launch_counts()
    for name, axis in SWEEPS:
        spec = get_spec(name)
        grid = GridSpec.uniform(axis, spec.ndims, name=f"{axis}")
        grids[name] = (spec, grid)
        before = ops.launch_counts()
        res = sweep(spec, grid.points(), runner=runner, atlas=atlas_for(spec))
        after = ops.launch_counts()
        by_family[name] = {k: after[k] - before[k] for k in after}
        n_algos = len(spec.algorithms(grid.points()[0]))
        print(f"sweep {spec.name} over {axis}^{spec.ndims}: points="
              f"{res.n_points} x {n_algos} algorithms measured="
              f"{res.n_measured} skipped={res.n_skipped} anomalies="
              f"{len(res.anomalies)} ({res.anomaly_rate:.1%}) in "
              f"{res.wall_s:.1f}s")
        print(f"fastpath: {res.fastpath.summary()}")
        print(region_summary(cluster_sweep(res.records, grid), res.n_points))
        if res.n_points != grid.n_points or res.n_measured != grid.n_points:
            raise AssertionError(f"{name}: sweep measured {res.n_measured} of "
                                 f"{grid.n_points} points")
        if res.fastpath.memo_hits or res.fastpath.memo_misses != \
                res.n_measured * n_algos:
            raise AssertionError(f"{name}: graph memo {res.fastpath.summary()}"
                                 f", not one capture per algorithm")
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
    return launches, by_family


def _agree(torch, label: str, got, want, quiet: bool = False) -> None:
    """max|got - want| <= 1e-3 + 1e-4·max|want|, finite, same shape;
    printed unless ``quiet``."""
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not quiet:
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


def check_flash(torch, np, cases=FLASH_CASES) -> dict:
    """Phase 6: the flash-attention kernel against its plain version at
    ``cases``; the first is the main path's shape, where the check must
    reject the planted fault, and its times are returned."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED)
    result = {"max_abs_err": 0.0}
    for label, b, h, hkv, s, d, dtype, kw in cases:
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


def aten_calls_per_decode_step(torch, api, model, cfg, batch: int,
                               batch_inputs=None) -> int:
    """ATen operator calls one decode step dispatches (views included),
    counted on a scratch cache (the encdec family's from
    ``batch_inputs``): the host-side work of an eager step."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    caches = api.init_caches(model, cfg, batch, 2, batch_inputs=batch_inputs)
    tokens = torch.zeros((batch, 1), dtype=torch.long, device="cuda")
    with Count() as count:
        api.decode_step(model, cfg, tokens, caches)
    return count.n


def timed_prefill(torch, api, model, cfg, tokens, caches, inputs=None):
    """One ``api.prefill`` of ``tokens`` (and the stub frontend's
    ``inputs``, such as ``vision_embeds``) between CUDA events, each flash
    launch timed by its own event pair → (logits, caches, prefill ms,
    flash ms, flash launches)."""
    from repro_torch.kernels import flash_attention as flash_mod

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

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    flash_mod.flash_attention_cuda = timed_launch
    try:
        start.record()
        logits, caches = api.prefill(model, cfg,
                                     dict(inputs or {}, tokens=tokens),
                                     caches)
        end.record()
        torch.cuda.synchronize()
    finally:
        flash_mod.flash_attention_cuda = launch
    flash_ms = sum(a.elapsed_time(z) for a, z in flash_events)
    return (logits, caches, start.elapsed_time(end), flash_ms,
            len(flash_events))


def greedy_decode(torch, api, model, cfg, logits, caches, n_new: int):
    """``n_new`` greedy tokens from a prefill's last logits and caches →
    (logits (B, n_new + 1, V) from the prefill's last on, the tokens fed
    and the next one (B, n_new + 1), caches, ms/token by CUDA events)."""
    last = logits[:, -1]
    tok = torch.argmax(last, dim=-1)[:, None]
    generated, decode_logits = [tok], [last]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n_new):
        step_logits, caches = api.decode_step(model, cfg, tok, caches)
        decode_logits.append(step_logits[:, 0])
        tok = torch.argmax(step_logits[:, -1], dim=-1)[:, None]
        generated.append(tok)
    end.record()
    torch.cuda.synchronize()
    return (torch.stack(decode_logits, dim=1), torch.cat(generated, dim=1),
            caches, start.elapsed_time(end) / n_new)


def decode_agrees(torch, dec, chosen, ref_logits) -> bool:
    """Print decode's logits ``dec`` and greedy tokens ``chosen`` against a
    re-prefill's ``ref_logits`` at the same positions; True when every
    logit is finite and within :data:`DECODE_LOGIT_TOL` and the greedy
    tokens agree wherever the re-prefill's top-2 margin exceeds it."""
    b, n = chosen.shape
    diff = (dec - ref_logits).abs()
    max_err, mean_err = float(diff.max()), float(diff.mean())
    top2 = torch.topk(ref_logits, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    agree = chosen == torch.argmax(ref_logits, dim=-1)
    decided = margin > DECODE_LOGIT_TOL
    print(f"decode vs re-prefill logits over {n} positions x "
          f"{b}: max|d|={max_err:.4f} mean|d|={mean_err:.5f} (tol "
          f"{DECODE_LOGIT_TOL}); logit std {float(ref_logits.std()):.3f}; "
          f"greedy tokens agree at {int(agree.sum())}/{agree.numel()}, at "
          f"{int((agree & decided).sum())}/{int(decided.sum())} where the "
          f"re-prefill's top-2 margin exceeds the tolerance")
    return bool(torch.isfinite(dec).all()) and max_err <= DECODE_LOGIT_TOL \
        and bool(agree[decided].all())


def serve_model(torch, np) -> dict:
    """Phase 7: Yi-9B at full width and depth on the card."""
    from repro_torch import configs
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
    ops.reset_launch_counts()
    logits, caches, prefill_ms, flash_ms, n_flash = timed_prefill(
        torch, api, model, cfg, prompt, api.init_caches(model, cfg, b, max_s))
    after_prefill = ops.launch_counts()
    print(f"prefill {b}x{s0}: {prefill_ms:.1f} ms, flash_attention "
          f"{flash_ms:.1f} ms in {n_flash} launches "
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
    dec, generated, caches, decode_ms = greedy_decode(
        torch, api, model, cfg, logits, caches, n_new)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    print(f"decode {n_new} tokens x {b} requests: {decode_ms:.2f} ms/token "
          f"({aten_calls_per_decode_step(torch, api, model, cfg, b)} ATen "
          f"calls a step); launches {ops.launch_counts()}")
    if ops.launch_counts() != after_prefill or caches.kv.length != max_s:
        raise AssertionError("decode launched a kernel or lost a token")

    # Re-prefill over prompt + the 128 tokens fed to decode.
    seq = torch.cat([prompt, generated[:, :-1]], dim=1)
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

    if not decode_agrees(torch, dec, generated, logits2[:, s0 - 1:]):
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


def run_cli(main, argv, ok=(0,)):
    """Run a CLI ``main`` in this process: its standard output, printed,
    and its exit code. An exit code outside ``ok`` raises."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    text = out.getvalue()
    print(text, end="")
    if rc not in ok:
        raise AssertionError(f"{argv} exited {rc}")
    return text, rc


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
        k: timed[k] * EXECUTIONS for k in ("gemm", "syrk", "symm")}
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

    # What a graph-timed call costs beyond the launch model (one replay's
    # launch and the synchronise, plus the model's error): calibrated time
    # minus the model's launch time, over the paper-scale calls the
    # families make (dims 400-1200). It sets H100_SXM.kernel_overhead_s.
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
            text, _ = run_cli(sweep_mod.main, [
                "--expr", name, "--grid", grid_of[name], "--mode",
                "predict", "--reps", str(REPS), "--seed", str(SEED),
                "--device", DEVICE, "--atlas-dir", str(atlas_dir),
                "--quiet"])
            got = ops.launch_counts()
            launches.update(got)
            want = dict.fromkeys(got, 0) | {
                k: new[k] * EXECUTIONS for k in ("gemm", "syrk", "symm")}
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


#: Phase 9: the point whose algorithms are timed three ways, and the
#: repetitions of each timing.
TIMING_POINT = ("aatb", (1200, 800, 400))
TIMING_REPS = 20
#: The walker's step operations a walk is recorded by.
STEP_OPS = ("gemm", "syrk", "symm", "symm_r", "tri2full", "chain_gemm",
            "gemm_syrk")
#: Phase 9's adaptive sweep: aatb in the paper's Experiment 1 box
#: [20, 1200] at a step of 40 (30³ = 27,000 grid points), a seed lattice
#: of every 8th index (5³ = 125 points) and a budget of 2,000 points (7.4 %
#: of the dense grid; 400 took 9.4 s on the card, PERF.md section 6).
ADAPTIVE_AXIS = tuple(range(40, 1201, 40))
ADAPTIVE_STRIDE = 8
ADAPTIVE_BUDGET = 2000


def step_calls(runner, alg, operands):
    """(name, op, arguments) of every step op one walk of ``alg`` makes on
    the runner's kernel vocabulary, a fused pair as one."""
    from repro_torch.core.backends import walk_steps

    inner = runner.ops()
    calls = []

    class Recorder:
        def __getattr__(self, name):
            fn = getattr(inner, name)
            if name not in STEP_OPS:
                return fn

            def record(*args):
                calls.append((name, fn, args))
                return fn(*args)

            return record

    walk_steps(alg.steps, operands.__getitem__, Recorder())
    return calls


def eager_seconds(torch, runner, alg, operands, reps: int) -> float:
    """Median seconds of the eager walk under ``time_algorithm``'s own
    protocol (a warm-up; then synchronise, clock, walk, synchronise,
    clock): how every algorithm was timed before graph replay."""
    import statistics

    def sync():
        if DEVICE == "cuda":
            torch.cuda.synchronize()

    runner.execute(alg, operands)
    ts = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        runner.execute(alg, operands)
        sync()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def time_algorithms(torch, family: str, point, reps: int = TIMING_REPS,
                    label: str = "") -> list:
    """Every algorithm of ``family`` at ``point`` on the ``cuda`` backend:
    its eager time, its ``time_algorithm`` time (a replayed CUDA graph on
    a tree with graph timing) and the sum of its steps' back-to-back
    times (``ms_b2b``), with the ratio of each algorithm time to that sum
    (the host's share shows above 1). Where the tree times graphs, the
    replay's result is held against the eager walk's: bitwise, or for an
    algorithm with a fused kernel that adds with atomics, within the
    algorithm tolerance of phase 5."""
    from repro_torch.core.backends import get_backend, register_torch_backends
    from repro_torch.core.expressions import get_spec

    register_torch_backends()
    runner = get_backend("cuda", reps=reps, seed=SEED, device=DEVICE)
    timing = getattr(runner, "timing", "eager")
    algos = get_spec(family).algorithms(point)
    operands = {}
    for alg in algos:
        for base, buf in runner.make_operands(alg).items():
            operands.setdefault(base, buf)
    rows = []
    for alg in algos:
        eager_ms = eager_seconds(torch, runner, alg, operands, reps) * 1e3
        timed_ms = runner.time_algorithm(alg, operands) * 1e3
        calls = step_calls(runner, alg, operands)
        if timing == "graph":
            replayed = runner._timed_callable(alg, operands)().clone()
            walked = runner.execute(alg, operands)
            if any(n in ("chain_gemm", "gemm_syrk") for n, _, _ in calls):
                _agree(torch, f"{family}{point} {alg.name} replay vs eager",
                       replayed, walked)
            elif not torch.equal(replayed, walked):
                raise AssertionError(f"{family}{point} {alg.name}: the "
                                     f"replayed graph differs from the "
                                     f"eager walk")
        steps = [(name, time_ms(torch, lambda f=fn, a=args: f(*a), inner=10))
                 for name, fn, args in calls]
        b2b = sum(ms for _, ms in steps)
        row = {"algorithm": alg.name, "point": list(point), "timing": timing,
               "eager_ms": eager_ms, "timed_ms": timed_ms,
               "b2b_sum_ms": b2b, "eager_over_b2b": eager_ms / b2b,
               "timed_over_b2b": timed_ms / b2b,
               "steps": [[n, ms] for n, ms in steps]}
        print(f"{label}{family}{point} {alg.name}: eager_ms={eager_ms:.4f} "
              f"{timing}_ms={timed_ms:.4f} b2b_sum_ms={b2b:.4f} (" +
              ", ".join(f"{n} {ms:.4f}" for n, ms in steps) +
              f"); eager/b2b={eager_ms / b2b:.3f} "
              f"{timing}/b2b={timed_ms / b2b:.3f}")
        rows.append(row)
    return rows


def _atlas_merge():
    """``tools/atlas_merge.py`` (standard library only), loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "atlas_merge", ROOT / "tools" / "atlas_merge.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["atlas_merge"] = mod   # its dataclasses look the module up
    spec.loader.exec_module(mod)
    return mod


def sweep_engine(torch, atlas_dir: Path, phase4: dict) -> None:
    """Phase 9: graph vs eager timing, the sweep without the fast path,
    --compare-backends and the adaptive sweep, sharded and merged."""
    from repro_torch.core import sweep as sweep_mod
    from repro_torch.kernels import ops

    time_algorithms(torch, *TIMING_POINT)

    grid = ",".join(map(str, dict(SWEEPS)["aatb"]))
    common = ["--expr", "aatb", "--reps", str(REPS), "--seed", str(SEED),
              "--device", DEVICE, "--quiet"]

    def atlas_of(text: str) -> Path:
        return Path(re.findall(r"atlas written to (\S+)", text)[-1])

    # The sweep without the fast path: the same points, the same launches.
    ops.reset_launch_counts()
    text, _ = run_cli(sweep_mod.main, common + [
        "--grid", grid, "--no-fastpath",
        "--atlas-dir", str(atlas_dir / "no-fastpath")])
    os.environ.pop(sweep_mod.FASTPATH_ENV, None)
    got = ops.launch_counts()
    slow = {r.point for r in _read_atlas(atlas_of(text))}
    fast = {r.point for r in _read_atlas(next(
        atlas_dir.glob("atlas-aatb-*.jsonl")))}
    print(f"no-fastpath aatb: {len(slow)} points, launches {got}")
    if "fastpath:" in text or slow != fast or got != phase4["aatb"]:
        raise AssertionError(f"--no-fastpath recorded {len(slow)} points and "
                             f"launched {got}; the fast path "
                             f"{len(fast)} and {phase4['aatb']}")

    # Both backends over the grid.
    ops.reset_launch_counts()
    text, _ = run_cli(sweep_mod.main, common + [
        "--grid", grid, "--compare-backends", "torch,cuda",
        "--atlas-dir", str(atlas_dir / "compare")])
    got = ops.launch_counts()
    m = re.search(r"fastest-differs=(\d+)", text)
    print(f"compare-backends launches {got}")
    if m is None or got != phase4["aatb"]:
        raise AssertionError(f"--compare-backends launched {got}, not "
                             f"{phase4['aatb']}")

    # The adaptive sweep in the paper's box, unsharded, then two shards.
    adaptive = common + [
        "--grid", ",".join(map(str, ADAPTIVE_AXIS)), "--mode", "adaptive",
        "--budget", str(ADAPTIVE_BUDGET), "--seed-stride",
        str(ADAPTIVE_STRIDE)]
    t0 = time.perf_counter()
    whole, _ = run_cli(sweep_mod.main, adaptive + [
        "--atlas-dir", str(atlas_dir / "adaptive")])
    whole_s = time.perf_counter() - t0
    shard_dir = atlas_dir / "adaptive-shards"
    t0 = time.perf_counter()
    for attempt in range(20):
        rcs = [run_cli(sweep_mod.main, adaptive + [
            "--shard", f"{k}/2", "--atlas-dir", str(shard_dir)],
            ok=(0, 3))[1] for k in (0, 1)]
        if rcs == [0, 0]:
            break
    else:
        raise AssertionError("the two shards did not finish in 20 rounds")
    shards_s = time.perf_counter() - t0
    paths = sorted(shard_dir.glob("atlas-aatb-*-shard*.jsonl"))
    merge = _atlas_merge()
    merged_path = shard_dir / "merged.jsonl"
    report = merge.merge_shards(paths, merged_path)
    print(report.summary())
    head = json.loads(merged_path.read_text().splitlines()[0])
    merged = _read_atlas(merged_path)
    parts = [{r.point for r in _read_atlas(p, shard=(k, 2))}
             for k, p in enumerate(paths)]
    spent = int(re.search(r"spent=(\d+)", whole).group(1))
    whole_records = _read_atlas(atlas_of(whole))
    if DEVICE == "cuda":
        print(f"device memory: peak reserved "
              f"{torch.cuda.max_memory_reserved() / 2 ** 30:.2f} GiB, now "
              f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB")
    print(f"adaptive aatb in [20, 1200] step 40: unsharded spent {spent} in "
          f"{whole_s:.1f}s, {sum(r.cls.is_anomaly for r in whole_records)} "
          f"anomalies; sharded {len(parts[0])} + {len(parts[1])} points in "
          f"{shards_s:.1f}s over {attempt + 1} lockstep rounds, merged "
          f"{len(merged)} ({sum(r.cls.is_anomaly for r in merged)} anomalies), "
          f"header timing={head.get('timing')!r} shard={head.get('shard')}")
    if len(paths) != 2 or parts[0] & parts[1] or \
            {r.point for r in merged} != parts[0] | parts[1] or \
            report.n_duplicates or not 0 < len(merged) <= ADAPTIVE_BUDGET \
            or head.get("timing") != ("graph" if DEVICE == "cuda" else
                                      "eager") or "shard" in head:
        raise AssertionError("the merged shards are not the union of two "
                             "disjoint graph-timed shard atlases")


#: Phase 10: the tune's grid and budget, the plans held against their
#: plain compositions (aatb at phase 9's point; Yi-9B's decode MLP and
#: attention tail in float32 at phase 7's cache length), the served
#: decode (2 requests, 2048 prompt tokens, 16 new ones).
TUNE_GRID, TUNE_BUDGET, TUNED_CHECKS = "default", 8, 4
PLANS = (("aatb", (1200, 800, 400)), ("decmlp", (2, 4096, 11008)),
         ("decattn", (1, 2176, 128, 4096)))
CONSULT_NEW = 16


def _tune(torch, np, tune_dir: Path):
    """Phase 10, part 1: ``calibrate --tune`` into ``tune_dir``; per-kind
    counts and ratios; the table reloads equal; launches exact."""
    import statistics

    from repro_torch.core import calibrate as cal
    from repro_torch.core.tuning import (card_limits, default_config,
                                         load_default_tuning_table)
    from repro_torch.kernels import ops

    os.environ["REPRO_PROFILE_DIR"] = str(tune_dir)
    os.environ.pop("REPRO_NO_TUNING", None)
    release(torch)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = cal.tune(backend="cuda", grid=TUNE_GRID, reps=REPS,
                   budget=TUNE_BUDGET, seed=SEED, device=DEVICE)
    launches = ops.launch_counts()
    peak = (torch.cuda.max_memory_reserved() / 2 ** 30
            if DEVICE == "cuda" else 0.0)
    print(f"phase 10 tune: calibrate --tune --grid {TUNE_GRID} "
          f"--tune-budget {TUNE_BUDGET}: tuned {res.n_requests} kernel "
          f"shapes on {res.fingerprint.backend}/{res.fingerprint.device}/"
          f"{res.fingerprint.dtype} in {res.wall_s:.1f}s; peak reserved "
          f"{peak:.2f} GiB; table written to {res.path}")
    limits = card_limits(DEVICE)
    table = res.table
    by_kind, differ = {}, {}
    for (kind, dims), e in sorted(table.entries.items()):
        k = by_kind.setdefault(kind, {"requests": 0, "timed": 0,
                                      "pruned": 0, "differ": 0,
                                      "ratios": []})
        k["requests"] += 1
        k["timed"] += e.timed
        k["pruned"] += e.pruned
        k["ratios"].append(e.default_seconds / e.seconds)
        if e.seconds > e.default_seconds:
            raise AssertionError(f"{kind}{dims}: winner {e.seconds} s "
                                 f"slower than the model's pick "
                                 f"{e.default_seconds} s")
        if e.config != default_config(kind, dims, limits):
            k["differ"] += 1
            differ.setdefault(kind, []).append((dims, e.config))
    for kind, k in by_kind.items():
        r = sorted(k["ratios"])
        print(f"phase 10 tune {kind}: requests={k['requests']} "
              f"timed={k['timed']} pruned={k['pruned']} "
              f"winner!=model={k['differ']}; model/winner median="
              f"{statistics.median(r):.3f} worst={r[-1]:.3f}")
    ratios = sorted(x for k in by_kind.values() for x in k["ratios"])
    print(f"phase 10 tune all: requests={len(table)} winner!=model="
          f"{sum(k['differ'] for k in by_kind.values())}; model/winner "
          f"median={statistics.median(ratios):.3f} worst={ratios[-1]:.3f}; "
          f"launches {launches}")
    want = {"gemm": by_kind["gemm"]["timed"], "syrk": by_kind["syrk"]["timed"],
            "symm": by_kind["symm"]["timed"],
            "chain_gemm": by_kind["chain_gemm"]["timed"],
            "gemm_syrk": by_kind["gemm_syrk"]["timed"]}
    want = {k: n * EXECUTIONS if DEVICE == "cuda" else 0
            for k, n in want.items()}
    if {k: launches[k] for k in want} != want or launches["flash_attention"]:
        raise AssertionError(f"the tune launched {launches}, not timed "
                             f"candidates x {EXECUTIONS}: {want}")
    reloaded = load_default_tuning_table(device=DEVICE)
    if reloaded is None or reloaded.entries != table.entries:
        raise AssertionError("the saved tuning table does not reload equal")
    return table, differ, launches


def _tuned_launches(torch, np, table, differ) -> None:
    """Phase 10, part 2: kernels under winners that differ from the model's
    pick against their plain versions; a table entry traced through the
    ``cuda`` backend to the launch it makes."""
    from repro_torch.core.backends import (get_backend, synthetic_algorithm,
                                           synthetic_fused_algorithm)
    from repro_torch.core.flops import KernelCall
    from repro_torch.core.tuning import KERNELS, card_limits, launch_config
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED)
    limits = card_limits(DEVICE)

    def mat(r, c):
        return torch.from_numpy(rng.standard_normal((r, c))).float().to(
            DEVICE)

    def operands(kind, dims):
        if kind == "gemm":
            m, n, k = dims
            return mat(m, k), mat(k, n)
        if kind == "syrk":
            return (mat(*dims),)
        if kind == "symm":
            m, n = dims
            return mat(m, m), mat(m, n)
        if kind == "chain_gemm":
            m, k, l, n = dims
            return mat(m, k), mat(k, l), mat(l, n)
        m, k, l = dims
        return mat(m, k), mat(k, l)

    for kind, winners in sorted(differ.items()):
        for dims, config in winners[:TUNED_CHECKS]:
            cfg = launch_config(kind, dims, config, limits)
            args = operands(kind, dims)
            out = getattr(ops, kind)(*args, config=cfg)
            expect = getattr(ref, kind)(*args)
            if DEVICE == "cuda":
                torch.cuda.synchronize()
            rtol, atol = TOL[kind]
            diff = (out - expect).abs()
            if kind == "gemm_syrk":
                ok = float(diff.max()) <= atol + rtol * float(
                    expect.abs().max())
            else:
                ok = bool((diff <= atol + rtol * expect.abs()).all())
            print(f"phase 10 tuned {kind}{dims} {config} ({cfg.name}): "
                  f"max_abs_err={float(diff.max()):.3e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"tuned {kind}{dims} {config} disagrees "
                                     f"with its plain version")
    # The table reaches the launch: one differing winner per kind, run
    # through the auto-loading backend with the kernel's launch spied on.
    if DEVICE != "cuda":
        return
    backend = get_backend("cuda", reps=1, seed=SEED)
    for kind, winners in sorted(differ.items()):
        dims, config = winners[0]
        mod = KERNELS[kind]
        seen, launch = [], mod.launch

        def spy(*args, _launch=launch):
            seen.append(args[-1])
            return _launch(*args)

        alg = (synthetic_fused_algorithm(kind, dims)
               if kind in ("chain_gemm", "gemm_syrk")
               else synthetic_algorithm(KernelCall(kind, dims)))
        mod.launch = spy
        try:
            backend.execute(alg, backend.make_operands(alg))
        finally:
            mod.launch = launch
        want = launch_config(kind, dims, config, limits)
        print(f"phase 10 dispatch {kind}{dims}: table {config} -> launch "
              f"{[c.name for c in seen]}")
        if seen != [want]:
            raise AssertionError(f"{kind}{dims}: the table's {config} did "
                                 f"not reach the launch ({seen})")


def _add(total: dict, counts: dict) -> dict:
    """``total`` with ``counts`` added in, key by key."""
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n
    return total


def _sweep_all(atlas_dir: Path, label: str, flags: list, phase4: dict,
               tuning) -> tuple:
    """Phase 4's three sweeps into ``atlas_dir / label``, with launches
    checked against phase 4's and the header's tuning against ``tuning``:
    ({family: (anomalies, points, {point: times})}, the three sweeps'
    launches summed)."""
    from repro_torch.core import sweep as sweep_mod
    from repro_torch.kernels import ops

    out, launched = {}, {}
    for name, axis in SWEEPS:
        ops.reset_launch_counts()
        try:
            text, _ = run_cli(sweep_mod.main, [
                "--expr", name, "--grid", ",".join(map(str, axis)),
                "--reps", str(REPS), "--seed", str(SEED), "--device", DEVICE,
                "--quiet", "--atlas-dir", str(atlas_dir / label)] + flags)
        finally:
            os.environ.pop("REPRO_NO_TUNING", None)
        got = ops.launch_counts()
        _add(launched, got)
        path = Path(re.findall(r"atlas written to (\S+)", text)[-1])
        lines = path.read_text().splitlines()
        head, records = json.loads(lines[0]), list(map(json.loads, lines[1:]))
        n = sum(r["is_anomaly"] for r in records)
        out[name] = (n, len(records),
                     {tuple(r["point"]): r["times"] for r in records})
        print(f"phase 10 sweep {name} {label}: {n}/{len(records)} anomalies;"
              f" header tuning={head.get('tuning')!r}; launches {got}")
        if got != phase4[name] or head.get("tuning") != tuning:
            raise AssertionError(f"{label} {name}: launched {got} (phase 4: "
                                 f"{phase4[name]}), header tuning "
                                 f"{head.get('tuning')!r}, not {tuning!r}")
    return out, launched


def _sweep_shape_table(torch, tune_dir: Path):
    """A tuning table of exactly the launches phase 4's sweeps make
    (``ab_bench.sweep_shapes``), saved in ``tune_dir``: whether a table
    tuned at the sweep's own shapes helps where the ``default`` grid's
    nearest entries did not."""
    import statistics

    from repro_torch.core.backends import get_backend
    from repro_torch.core.tuning import card_limits, default_config, \
        save_tuning_table
    from repro_torch.kernels.autotune import autotune

    import ab_bench

    shapes = ab_bench.sweep_shapes()
    requests = sorted(
        {("gemm", (m, n, k)) for m, k, n in shapes["gemm"]}
        | {("symm", (m, n)) for m, n, _ in shapes["symm"]}
        | {(kind, tuple(dims)) for kind in ("syrk", "chain_gemm",
                                            "gemm_syrk")
           for dims in shapes[kind]})
    runner = get_backend("cuda", reps=REPS, seed=SEED, device=DEVICE)
    t0 = time.perf_counter()
    table = autotune(runner, requests, reps=REPS, budget=TUNE_BUDGET)
    wall = time.perf_counter() - t0
    save_tuning_table(table, runner.fingerprint(), directory=tune_dir)
    limits = card_limits(DEVICE)
    differ = sum(e.config != default_config(k, d, limits)
                 for (k, d), e in table.entries.items())
    ratios = sorted(e.default_seconds / e.seconds
                    for e in table.entries.values())
    print(f"phase 10 sweep-shape tune: {len(requests)} requests in "
          f"{wall:.1f}s, winner!=model={differ}; model/winner median="
          f"{statistics.median(ratios):.3f} worst={ratios[-1]:.3f}")
    return table


def _tuned_sweeps(torch, atlas_dir: Path, phase4: dict, table) -> dict:
    """Phase 10, part 3: phase 4's sweeps with the table and with
    ``--no-tuning`` (exact launches, anomaly counts, resumes across the
    two tuning states refused), then with a table tuned at the sweep's
    own shapes. Returns the launches of each part."""
    from repro_torch.core import sweep as sweep_mod
    from repro_torch.core.sweep import AtlasError
    from repro_torch.kernels import ops

    runs, parts = {}, {}
    for label, flags, tuning in (("tuned", [], table.digest()),
                                 ("untuned", ["--no-tuning"], None)):
        runs[label], parts[f"sweep {label}"] = _sweep_all(
            atlas_dir, label, flags, phase4, tuning)
    ops.reset_launch_counts()
    for label, other in (("tuned", ["--no-tuning"]), ("untuned", [])):
        try:
            run_cli(sweep_mod.main, [
                "--expr", "aatb", "--grid",
                ",".join(map(str, dict(SWEEPS)["aatb"])), "--reps",
                str(REPS), "--seed", str(SEED), "--device", DEVICE,
                "--quiet", "--atlas-dir", str(atlas_dir / label)] + other)
        except AtlasError as e:
            print(f"phase 10 resume of the {label} atlas under the other "
                  f"tuning state refused: {str(e)[-90:]}")
        else:
            raise AssertionError(f"the {label} atlas resumed under the "
                                 f"other tuning state")
        finally:
            os.environ.pop("REPRO_NO_TUNING", None)
    parts["refused resumes"] = ops.launch_counts()
    if any(parts["refused resumes"].values()):
        raise AssertionError(f"a refused resume launched kernels: "
                             f"{parts['refused resumes']}")

    default_dir = os.environ["REPRO_PROFILE_DIR"]
    os.environ["REPRO_PROFILE_DIR"] = str(atlas_dir / "tuning-sweep")
    try:
        ops.reset_launch_counts()
        own = _sweep_shape_table(torch, atlas_dir / "tuning-sweep")
        parts["sweep-shape tune"] = ops.launch_counts()
        runs["sweep-tuned"], parts["sweep sweep-tuned"] = _sweep_all(
            atlas_dir, "sweep-tuned", [], phase4, own.digest())
    finally:
        os.environ["REPRO_PROFILE_DIR"] = default_dir

    for label in ("tuned", "sweep-tuned"):
        for name, _ in SWEEPS:
            tuned, untuned = runs[label][name][2], runs["untuned"][name][2]
            algs = sorted(next(iter(tuned.values())))
            ratios = {a: sorted(tuned[p][a] / untuned[p][a] for p in tuned)
                      for a in algs}
            print(f"phase 10 {name} {label}/untuned time by algorithm, "
                  f"median (min, max) over {len(tuned)} points: " + ", ".join(
                      f"{a} {r[len(r) // 2]:.3f} ({r[0]:.3f}, {r[-1]:.3f})"
                      for a, r in ratios.items()))
    print("phase 10 anomalies tuned / sweep-tuned / --no-tuning: " + ", ".join(
        f"{name} {runs['tuned'][name][0]} / {runs['sweep-tuned'][name][0]} "
        f"/ {runs['untuned'][name][0]} of {runs['tuned'][name][1]}"
        for name, _ in SWEEPS))
    return parts


def plan_args(operands: dict) -> list:
    """A plan's positional arguments from base-indexed operands: a plan
    reads leaf ``base`` at position ``base`` (the reference's ``fn(A, A,
    B)`` for A·Aᵀ·B); positions of no base are never read."""
    return [operands.get(b) for b in range(max(operands) + 1)]


def _planner(torch) -> None:
    """Phase 10, part 4: ``PlanService`` on the ``cuda`` backend."""
    from repro_torch.core.backends import measure_seconds
    from repro_torch.core.discriminants import as_hybrid
    from repro_torch.core.expressions import get_spec
    from repro_torch.core.planner import Planner
    from repro_torch.serve.loadtest import run_loadtest
    from repro_torch.serve.plan_cache import PlanService

    svc = PlanService(backend="cuda", device=DEVICE)
    print(f"phase 10 planner: profile "
          f"{type(svc.planner.profile).__name__}, discriminant "
          f"{svc.planner.discriminant}")
    for family, dims in PLANS:
        plan = svc.lookup(family, dims)
        operands = svc.planner.runner.make_operands(plan.algorithm)
        args = plan_args(operands)
        got = svc.execute(family, dims, *args)
        want = get_spec(family).reference_value(dims, operands)
        _agree(torch, f"phase 10 plan {family}{dims} {plan.algorithm.name} "
                      f"(ranked {list(plan.ranked)})", got, want)
        _, seconds = measure_seconds(plan.fn, *args)
        ms = (time_ms(torch, lambda: plan.fn(*args)) if DEVICE == "cuda"
              else float("nan"))
        print(f"phase 10 plan {family}{dims}: measure_seconds "
              f"{seconds * 1e3:.4f} ms, CUDA events {ms:.4f} ms")
        if svc.lookup(family, dims) is not plan:
            raise AssertionError(f"{family}: a second lookup re-planned")

    # Refinement: timings folded by the worker bump the generation, and
    # the next lookup misses once.
    planner = Planner(backend="cuda", device=DEVICE, record=True,
                      profile=as_hybrid(None))
    svc = PlanService(planner=planner, refine=True)
    family, dims = PLANS[0]
    plan = svc.lookup(family, dims)
    args = plan_args(planner.runner.make_operands(plan.algorithm))
    gen0 = planner.profile_generation()
    planner(get_spec(family).chain(dims), *args)   # record=True: observes
    if planner.profile_generation() <= gen0:
        raise AssertionError("a recording planner call folded no timing")
    for _ in range(8):
        svc.execute(family, dims, *args)
    if not svc.shutdown(drain=True):
        raise AssertionError("the refinement worker did not drain")
    before = svc.cache.stats()
    svc.lookup(family, dims)
    svc.lookup(family, dims)
    after = svc.cache.stats()
    table = planner.profile.table_profile.table
    print(f"phase 10 refinement: generation {gen0} -> "
          f"{planner.profile_generation()}, 1 + {svc.stats()['refine_steps']}"
          f" timings folded; table {sorted((k[0], k[1], round(v * 1e6, 2)) for k, v in table.items())} us; "
          f"next lookups misses +{after['misses'] - before['misses']} "
          f"hits +{after['hits'] - before['hits']}")
    if planner.profile_generation() <= gen0 or \
            after["misses"] - before["misses"] != 1 or \
            after["hits"] - before["hits"] != 1:
        raise AssertionError("refinement did not invalidate the plan once")

    def make_service():
        return PlanService(backend="cuda", device=DEVICE)

    rep = run_loadtest(make_service(), requests=2000, threads=8,
                       make_service=make_service)
    print(f"phase 10 loadtest: requests={rep.requests} threads={rep.threads} "
          f"hit p50={rep.hit_p50_us:.1f}us p99={rep.hit_p99_us:.1f}us "
          f"(hit rate {rep.hit_rate:.1%}), miss p50={rep.miss_p50_us:.1f}us "
          f"p99={rep.miss_p99_us:.1f}us, coalescing "
          f"{rep.coalesce_effectiveness:.1%} (burst enumerations "
          f"{rep.burst_misses})")
    if rep.burst_misses != 1 or rep.stats["errors"]:
        raise AssertionError("the load test's burst did not coalesce into one "
                             "enumeration")


def _served_consult(torch, np) -> dict:
    """Phase 10, part 5: Yi-9B decode with the plan consult on (after
    ``plan_warmup``) and off, from one prefill's cache. The consult is
    made once per cache (``transformer.plan_decode``, which
    ``init_caches`` calls); a decode step makes none."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import api, transformer
    from repro_torch.serve.decode import plan_warmup
    from repro_torch.serve.plan_cache import (default_plan_service,
                                              reset_default_plan_service)

    cfg = configs.get("yi_9b")
    model = api.init(cfg, seed=SEED, device=DEVICE, dtype=torch.bfloat16)
    b, s0, n_new = SERVE_BATCH, SERVE_PROMPT, CONSULT_NEW
    max_s = s0 + n_new
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s0))).to(DEVICE)
    reset_default_plan_service()
    os.environ.pop("REPRO_SERVE_PLANNER", None)
    shapes = plan_warmup(cfg, max_s, device=DEVICE)
    svc = default_plan_service(DEVICE)
    for family, dims in shapes:
        print(f"phase 10 warmed {family}{dims}: "
              f"{svc.lookup(family, dims).algorithm.name}")
    logits, caches = api.prefill(model, cfg, {"tokens": prompt},
                                 api.init_caches(model, cfg, b, max_s))
    k0, v0 = caches.kv.k.clone(), caches.kv.v.clone()
    first = torch.argmax(logits[:, -1], dim=-1)[:, None]
    del logits

    def decode(planned):
        caches.kv.k.copy_(k0)
        caches.kv.v.copy_(v0)
        state, tok, out = planned._replace(
            kv=planned.kv._replace(length=s0)), first, [first]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_new):
            step_logits, state = api.decode_step(model, cfg, tok, state)
            tok = torch.argmax(step_logits[:, -1], dim=-1)[:, None]
            out.append(tok)
        torch.cuda.synchronize()
        return torch.cat(out, dim=1), (time.perf_counter() - t0) * 1e3 / n_new

    decode(caches)   # warm-up (allocator, cuBLAS heuristics), not counted
    # In turns (on, off, on, off): the host's noise between runs is as
    # large as the difference looked for. Each run plans its cache anew.
    runs, hits, consult_us, orders = {"on": [], "off": []}, [], [], []
    for state in ("on", "off", "on", "off"):
        before = svc.cache.stats()
        if state == "off":
            os.environ["REPRO_SERVE_PLANNER"] = "0"
        try:
            t0 = time.perf_counter()
            planned = transformer.plan_decode(cfg, caches)
            if state == "on":
                consult_us.append((time.perf_counter() - t0) * 1e6)
            runs[state].append(decode(planned))
        finally:
            os.environ.pop("REPRO_SERVE_PLANNER", None)
        after = svc.cache.stats()
        hits.append(after["hits"] - before["hits"])
        orders.append("right" if planned.kv.right_first else "left")
        if after["misses"] != len(set(shapes)):
            raise AssertionError(f"the decode's consult missed: {after}")
    tokens = [t for state in runs.values() for t, _ in state]
    ms = {state: [m for _, m in r] for state, r in runs.items()}
    print(f"phase 10 decode {n_new} tokens x {b} (cache {max_s}), in turns: "
          f"consult on {ms['on'][0]:.2f}, {ms['on'][1]:.2f} ms/token; "
          f"REPRO_SERVE_PLANNER=0 {ms['off'][0]:.2f}, {ms['off'][1]:.2f} "
          f"ms/token; the consult {consult_us[0]:.1f}, {consult_us[1]:.1f} "
          f"us per cache (a step makes none); association per run {orders}; "
          f"plan cache misses {len(set(shapes))} (warm-up), hits per run "
          f"{hits}; tokens equal: "
          f"{all(torch.equal(t, tokens[0]) for t in tokens)}; launches "
          f"{ops.launch_counts()}")
    if hits != [1, 0] * 2 or \
            not all(torch.equal(t, tokens[0]) for t in tokens):
        raise AssertionError("the served decode's consult did not hit once "
                             "per cache, or changed the tokens")
    del model, caches
    return {"decode_ms_consult": ms["on"], "decode_ms_off": ms["off"],
            "consult_us_per_cache": consult_us}


def tuning_and_planner(torch, np, atlas_dir: Path, phase4: dict) -> dict:
    """Phase 10: the tune, tuned launches, tuned vs default sweeps, the
    planner and its serving cache, the served decode's consult. Each part
    past the tune is counted from 0 on its own (the sweeps reset the
    counts before each sweep and sum them); ``launches`` is their sum."""
    from repro_torch.kernels import ops

    tune_dir = atlas_dir / "tuning"
    table, differ, tune_launches = _tune(torch, np, tune_dir)
    ops.reset_launch_counts()
    _tuned_launches(torch, np, table, differ)
    parts = {"tuned checks": ops.launch_counts()}
    parts.update(_tuned_sweeps(torch, atlas_dir, phase4, table))
    release(torch)
    ops.reset_launch_counts()
    _planner(torch)
    parts["planner"] = ops.launch_counts()
    release(torch)
    ops.reset_launch_counts()
    served = _served_consult(torch, np)
    parts["decode"] = ops.launch_counts()
    release(torch)
    launches = {}
    for part, counts in parts.items():
        print(f"phase 10 launches, {part}: {counts}")
        _add(launches, counts)
    print(f"phase 10 kernel launches past the tune: {launches}")
    return {"launches": launches, "parts": parts,
            "tune_launches": tune_launches, **served}


#: Phase 11: the other decoder families. OLMoE-1B-7B prefills
#: OLMOE_PROMPT tokens a request and decodes OLMOE_NEW; Mamba2-370M
#: prefills MAMBA_PROMPT and decodes MAMBA_NEW (both prompt and re-prefill
#: multiples of its chunk of 128, as ``ssd_chunked`` needs); Zamba2-1.2B
#: generates ZAMBA_NEW tokens after a ZAMBA_PROMPT-token prompt fed token
#: by token (the family has no prefill). SERVE_BATCH requests each.
OLMOE_PROMPT, OLMOE_NEW = 2048, 32
MAMBA_PROMPT, MAMBA_NEW = 2048, 128
ZAMBA_PROMPT, ZAMBA_NEW = 128, 32
#: One OLMoE prefill layer: MHA, 16 heads of 128, bf16, causal.
OLMOE_FLASH_CASE = ("olmoe-1b-7b prefill B2 H16/16 S2048 D128 bf16 causal",
                    2, 16, 16, 2048, 128, "bfloat16", dict(causal=True))
#: max|gather - einsum| <= MOE_DISPATCH_TOL · max|einsum| of one MoE layer
#: in bf16. In one dispatch group the two route with the same ``_route``,
#: place the same rows in the same (E, C, d) slots and run the same three
#: batched products, so the expert outputs y_k are identical; they combine
#: differently. einsum sums g_k·y_k in float32 and rounds once to bf16
#: (at most 2**-8 of |y|); gather rounds each gate and each product to
#: bf16 (2**-8 each of g_k·|y_k|, with the g_k summing to 1: 2**-7 of the
#: largest |y_k|) and rounds its sum once more (2**-8 of |y|). The bound
#: is 2**-6 of the largest output, the combined output's max standing in
#: for the expert outputs'.
MOE_DISPATCH_TOL = 2 ** -6
#: (S, N, P, Q, heads) at which phase 11 prints ``select_ssd_mode``'s
#: picks: one Mamba2-370M prefill request of MAMBA_PROMPT tokens.
SSD_POINT = (MAMBA_PROMPT, 128, 64, 128, 32)


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) \
        or getattr(e, "self_cuda_time_total", 0)


def device_busy_ms(events) -> float:
    """The device's own time in a profile's ``key_averages()``: the sum
    over the entries whose device type is CUDA (kernels, memcpy, memset),
    user annotations left out. A host-side entry (an ATen op, a
    ``record_function`` range, a runtime call) reports the device time of
    the kernels it launched, and a ``record_function`` range's device-side
    annotation spans them: those kernels' own entries already count it."""
    return sum(_device_us(e) for e in events
               if _on_device(e)
               and not getattr(e, "is_user_annotation", False)) / 1e3


def _on_device(event) -> bool:
    """Whether a profile entry is the device's own (a kernel, a memcpy)."""
    return str(getattr(event, "device_type", "")).endswith("CUDA")


def device_time_by_op(torch, label: str, fn, top: int = 6,
                      phase: int = 11) -> dict:
    """Phases 11, 13 and 14: one call of ``fn`` under ``torch.profiler``;
    print the host's wall time, the device's (:func:`device_busy_ms`) and
    its share of the wall time, and the ``top`` ATen ops and hand kernels
    by the device time of the kernels they launched."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # a hand kernel by its own entry (a custom operator's host entry
    # would count the same kernel twice)
    ops_ = [e for e in events if e.key.startswith("aten::") or
            ("repro_" in e.key and _on_device(e))]
    device_ms = device_busy_ms(events)
    ranked = sorted(ops_, key=_device_us, reverse=True)[:top]
    print(f"phase {phase} profile {label}: wall {wall_ms:.1f} ms, device "
          f"{device_ms:.1f} ms ({device_ms / wall_ms:.0%}); by device "
          f"time: " + ", ".join(
              f"{e.key[:48]} {_device_us(e) / 1e3:.2f} ms x{e.count}"
              for e in ranked))
    return {"wall_ms": wall_ms, "device_ms": device_ms}


def check_params(model, cfg) -> None:
    """A served model's parameters against ``cfg.param_count()``, plus
    what the analytic count leaves out: norm gains, the vocabulary's pad
    rows and each Mamba2 layer's conv, conv bias and per-head vectors."""
    n_params = sum(p.numel() for p in model.parameters())
    norms = sum(p.numel() for name, p in model.named_parameters()
                if name.endswith(".g"))
    pad = (cfg.padded_vocab - cfg.vocab) * cfg.d_model * (
        1 if cfg.tied_embeddings else 2)
    mixers = 0
    if cfg.ssm is not None:
        s = cfg.ssm
        conv_ch = s.d_inner + 2 * s.n_groups * s.d_state
        mixers = cfg.n_layers * ((s.conv_kernel + 1) * conv_ch
                                 + 3 * s.n_heads)
    print(f"serve {cfg.name} ({cfg.family}): {cfg.n_layers} layers "
          f"d_model {cfg.d_model} vocab {cfg.vocab}; {n_params} parameters "
          f"(config count {cfg.param_count()} + {norms} norm gains + {pad} "
          f"pad rows + {mixers} conv/head vectors; active "
          f"{cfg.active_param_count()}) in bf16")
    if n_params != cfg.param_count() + norms + pad + mixers:
        raise AssertionError(f"{cfg.name}: parameter count differs from "
                             f"the config's")


def moe_dispatch_check(torch, p, mcfg, h) -> dict:
    """Phase 11: ``moe.apply`` gather against einsum dispatch on one MoE
    layer's real input ``h`` (B, S, d), in one dispatch group."""
    from repro_torch.models import moe

    b, s, d = h.shape
    nt = b * s
    groups = max(1, nt // max(mcfg.group_size, 1))
    cap = moe.capacity(mcfg, nt // groups)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gather, aux_g = moe.apply(p, mcfg._replace(dispatch="gather"), h)
    torch.cuda.synchronize()
    peak_gather = torch.cuda.max_memory_reserved()
    einsum, aux_e = moe.apply(p, mcfg._replace(dispatch="einsum"), h)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_reserved()
    _, idx, _ = moe._route(p, mcfg, h.reshape(nt, d))
    counts = torch.bincount(idx.reshape(-1), minlength=mcfg.n_experts)
    dropped = int((counts - cap).clamp_min(0).sum())
    err = float((gather.float() - einsum.float()).abs().max())
    scale = float(einsum.float().abs().max())
    print(f"phase 11 moe dispatch, layer 0's MLP input {tuple(h.shape)} "
          f"{h.dtype}: {groups} group(s) of {nt // groups} tokens, capacity "
          f"{cap} a expert, {dropped} of {nt * mcfg.top_k} assignments "
          f"dropped (per expert {counts.min().item()}..{counts.max().item()}"
          f"); gather vs einsum max|d|={err:.3e} of max|y|={scale:.3e} (tol "
          f"{MOE_DISPATCH_TOL:g}·max|y|); aux {float(aux_g):.6f} / "
          f"{float(aux_e):.6f}; peak reserved {peak_gather / 2 ** 30:.2f} "
          f"GiB (gather), {peak / 2 ** 30:.2f} GiB (einsum)")
    if groups != 1 or not bool(torch.isfinite(gather).all()) or \
            err > MOE_DISPATCH_TOL * scale or \
            abs(float(aux_g) - float(aux_e)) > 1e-6 * abs(float(aux_e)):
        raise AssertionError("the gather dispatch disagrees with the einsum "
                             "dispatch")
    return {"dispatch_max_abs_err": err, "dropped": dropped,
            "peak_reserved_gib": peak / 2 ** 30}


def serve_olmoe(torch, np) -> dict:
    """Phase 11: OLMoE-1B-7B at full width and depth, bf16."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import api, moe

    cfg = configs.get("olmoe_1b_7b")
    model = api.init(cfg, seed=SEED, device="cuda", dtype=torch.bfloat16)
    check_params(model, cfg)
    b, s0, n_new = SERVE_BATCH, OLMOE_PROMPT, OLMOE_NEW
    max_s = s0 + n_new
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s0))).cuda()

    # Warm-up prefill, not counted; it keeps layer 0's MLP input (the
    # first call of moe.apply) for the dispatch check.
    first, apply = [], moe.apply

    def keep_first(p, mcfg, x):
        if not first:
            first.append(x.clone())
        return apply(p, mcfg, x)

    moe.apply = keep_first
    try:
        api.prefill(model, cfg, {"tokens": prompt},
                    api.init_caches(model, cfg, b, max_s))
    finally:
        moe.apply = apply
    profiled = {"prefill": device_time_by_op(
        torch, f"olmoe prefill {b}x{s0}", lambda: api.prefill(
            model, cfg, {"tokens": prompt},
            api.init_caches(model, cfg, b, max_s)))}

    ops.reset_launch_counts()
    logits, caches, prefill_ms, flash_ms, n_flash = timed_prefill(
        torch, api, model, cfg, prompt, api.init_caches(model, cfg, b, max_s))
    launches = ops.launch_counts()
    print(f"phase 11 olmoe prefill {b}x{s0}: {prefill_ms:.1f} ms, "
          f"flash_attention {flash_ms:.1f} ms in {n_flash} launches "
          f"({flash_ms / prefill_ms:.1%} of prefill); launches {launches}")
    if launches["flash_attention"] != cfg.n_layers or \
            logits.shape != (b, s0, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()) or caches.kv.length != s0:
        raise AssertionError("olmoe prefill: flash not once per layer, or "
                             "bad logits or cache length")
    # Steps on the prefill's cache, their results dropped: each writes K/V
    # at position s0, which the first real step writes again.
    api.decode_step(model, cfg, prompt[:, -1:], caches)     # warm-up
    profiled["decode step"] = device_time_by_op(
        torch, "olmoe decode step", lambda: api.decode_step(
            model, cfg, prompt[:, -1:], caches))

    dec, generated, caches, decode_ms = greedy_decode(
        torch, api, model, cfg, logits, caches, n_new)
    del logits
    print(f"phase 11 olmoe decode {n_new} tokens x {b}: {decode_ms:.2f} "
          f"ms/token ({aten_calls_per_decode_step(torch, api, model, cfg, b)}"
          f" ATen calls a step); launches {ops.launch_counts()}")
    if ops.launch_counts() != launches or caches.kv.length != max_s:
        raise AssertionError("olmoe decode launched a kernel or lost a token")

    del caches
    dispatch = moe_dispatch_check(torch, model.blocks[0].moe, cfg.moe,
                                  first[0])
    del first

    # Re-prefill of the prompt and the tokens decode was fed: S = 2080 is
    # no multiple of 128, so attention takes the masked dense route (no
    # flash launch), as in the reference.
    seq = torch.cat([prompt, generated[:, :-1]], dim=1)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    logits2, _ = api.prefill(model, cfg, {"tokens": seq},
                             api.init_caches(model, cfg, b, max_s))
    end.record()
    torch.cuda.synchronize()
    print(f"phase 11 olmoe re-prefill {b}x{max_s}: "
          f"{start.elapsed_time(end):.1f} ms; launches {ops.launch_counts()}")
    if ops.launch_counts() != launches or \
            not bool(torch.isfinite(logits2).all()):
        raise AssertionError("olmoe re-prefill launched a kernel or gave "
                             "non-finite logits")
    print("phase 11 olmoe decode vs re-prefill (printed, not gated: a decode "
          "step routes 2 tokens with capacity max(int(1.25*2*8/64), 1) = 1 "
          "a expert, the prefill 4,160 with 650, so tokens the two route to "
          "one expert drop in one and are kept in the other):")
    decode_agrees(torch, dec, generated, logits2[:, s0 - 1:])
    del model, logits2
    return {"prefill_ms": prefill_ms, "flash_ms": flash_ms,
            "decode_ms_per_token": decode_ms, "launches": launches,
            "profile": profiled, **dispatch}


def serve_mamba2(torch, np) -> dict:
    """Phase 11: Mamba2-370M at full width and depth, bf16."""
    from repro_torch import configs
    from repro_torch.core.perfmodel import (AnalyticalHopperProfile,
                                            AnalyticalTPUProfile)
    from repro_torch.kernels import ops
    from repro_torch.models import api, ssm

    s, n, p, q, heads = SSD_POINT
    hopper = AnalyticalHopperProfile()
    modeled = {mode: sum(hopper.time(c, 2) for c in ssm.ssd_algorithm_calls(
        mode, s, n, p, q, heads)) * 1e3 for mode in ("quadratic", "chunked")}
    picks = {name: ssm.select_ssd_mode(s, n, p, q, heads=heads,
                                       discriminant=disc, profile=prof)
             for name, disc, prof in (
                 ("perfmodel/AnalyticalHopperProfile", "perfmodel", None),
                 ("flops", "flops", None),
                 ("perfmodel/AnalyticalTPUProfile", "perfmodel",
                  AnalyticalTPUProfile()))}
    print(f"phase 11 select_ssd_mode at (S {s}, N {n}, P {p}, Q {q}, H "
          f"{heads}): {picks}; Hopper model quadratic "
          f"{modeled['quadratic']:.4f} ms, chunked {modeled['chunked']:.4f} "
          f"ms (prefill runs chunked SSD with the state handed over)")

    cfg = configs.get("mamba2_370m")
    model = api.init(cfg, seed=SEED, device="cuda", dtype=torch.bfloat16)
    check_params(model, cfg)
    b, s0, n_new = SERVE_BATCH, MAMBA_PROMPT, MAMBA_NEW
    max_s = s0 + n_new
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s0))).cuda()
    api.prefill(model, cfg, {"tokens": prompt},
                api.init_caches(model, cfg, b, max_s))   # warm-up
    # The steps run on a scratch cache: a step updates the SSM state in
    # place, and its cost does not depend on the length.
    scratch = api.init_caches(model, cfg, b, max_s)
    api.decode_step(model, cfg, prompt[:, -1:], scratch)     # warm-up
    profiled = {
        "prefill": device_time_by_op(
            torch, f"mamba2 prefill {b}x{s0}", lambda: api.prefill(
                model, cfg, {"tokens": prompt},
                api.init_caches(model, cfg, b, max_s))),
        "decode step": device_time_by_op(
            torch, "mamba2 decode step", lambda: api.decode_step(
                model, cfg, prompt[:, -1:], scratch))}
    del scratch
    ops.reset_launch_counts()
    logits, caches, prefill_ms, _, _ = timed_prefill(
        torch, api, model, cfg, prompt, api.init_caches(model, cfg, b, max_s))
    print(f"phase 11 mamba2 prefill {b}x{s0}: {prefill_ms:.1f} ms")
    # 50,280 is no multiple of 16: the logits carry the reference's pad
    # columns (-1e30) up to padded_vocab.
    if logits.shape != (b, s0, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()) or \
            caches.ssm.length != s0:
        raise AssertionError("mamba2 prefill: bad logits or cache length")
    dec, generated, caches, decode_ms = greedy_decode(
        torch, api, model, cfg, logits, caches, n_new)
    del logits
    print(f"phase 11 mamba2 decode {n_new} tokens x {b}: {decode_ms:.2f} "
          f"ms/token ({aten_calls_per_decode_step(torch, api, model, cfg, b)}"
          f" ATen calls a step)")
    seq = torch.cat([prompt, generated[:, :-1]], dim=1)
    logits2, _, reprefill_ms, _, _ = timed_prefill(
        torch, api, model, cfg, seq, api.init_caches(model, cfg, b, max_s))
    launches = ops.launch_counts()
    print(f"phase 11 mamba2 re-prefill {b}x{max_s}: {reprefill_ms:.1f} ms; "
          f"launches {launches} (no kernel on this path)")
    if any(launches.values()) or caches.ssm.length != max_s:
        raise AssertionError("mamba2 launched a kernel or lost a token")
    v = cfg.vocab
    if not decode_agrees(torch, dec[..., :v], generated,
                         logits2[:, s0 - 1:, :v]):
        raise AssertionError("mamba2 decode disagrees with the re-prefill")
    del model, logits2, caches
    return {"prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "reprefill_ms": reprefill_ms, "ssd_modes": picks,
            "profile": profiled}


def serve_zamba2(torch, np) -> dict:
    """Phase 11: Zamba2-1.2B at full width and depth, bf16, through
    ``serve.decode.generate`` twice."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.serve.decode import generate

    cfg = configs.get("zamba2_1p2b")
    model = api.init(cfg, seed=SEED, device="cuda", dtype=torch.bfloat16)
    check_params(model, cfg)
    b, s0, n_new = SERVE_BATCH, ZAMBA_PROMPT, ZAMBA_NEW
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s0))).cuda()
    scratch = api.init_caches(model, cfg, b, s0 + n_new + 1)
    api.decode_step(model, cfg, prompt[:, :1], scratch)      # warm-up
    profiled = {"decode step": device_time_by_op(
        torch, "zamba2 decode step", lambda: api.decode_step(
            model, cfg, prompt[:, :1], scratch))}
    del scratch
    ops.reset_launch_counts()
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    step = api.decode_step

    def checked_step(*args, **kw):   # every step's logits finite
        logits, caches = step(*args, **kw)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, caches

    runs = []
    api.decode_step = checked_step
    try:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = generate(model, cfg, prompt, max_new=n_new)
            torch.cuda.synchronize()
            runs.append((out, (time.perf_counter() - t0) * 1e3
                         / (s0 - 1 + n_new)))
    finally:
        api.decode_step = step
    same = torch.equal(runs[0][0], runs[1][0])
    print(f"phase 11 zamba2 generate {b}x{s0} prompt (teacher-forced) + "
          f"{n_new} tokens, twice: {runs[0][1]:.2f}, {runs[1][1]:.2f} "
          f"ms/token over {s0 - 1 + n_new} steps "
          f"({aten_calls_per_decode_step(torch, api, model, cfg, b)} ATen "
          f"calls a step); tokens identical: {same}; logits finite: "
          f"{bool(finite)}; launches {ops.launch_counts()}")
    if not same or not bool(finite) or runs[0][0].shape != (b, s0 + n_new) \
            or any(ops.launch_counts().values()):
        raise AssertionError("zamba2: the two generations differ, a logit "
                             "is not finite, or a kernel launched")
    del model
    return {"decode_ms_per_token": [ms for _, ms in runs],
            "profile": profiled}


def serve_families(torch, np) -> dict:
    """Phase 11: flash at OLMoE's prefill shape, then OLMoE-1B-7B,
    Mamba2-370M and Zamba2-1.2B served at full width and depth; each
    model's peak reserved memory counted from its load."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    flash = check_flash(torch, np, cases=(OLMOE_FLASH_CASE,))
    flash["check_launches"] = ops.launch_counts()["flash_attention"]
    release(torch)
    served = {}
    for name, serve in (("olmoe", serve_olmoe), ("mamba2", serve_mamba2),
                        ("zamba2", serve_zamba2)):
        torch.cuda.reset_peak_memory_stats()
        served[name] = serve(torch, np)
        release(torch)
        print(f"phase 11 {name}: peak reserved "
              f"{torch.cuda.max_memory_reserved() / 2 ** 30:.2f} GiB")
    return {"flash": flash, **served}


#: Phase 13: the encdec and vlm families. InternVL2-76B at its published
#: widths with its depth cut to INTERNVL_LAYERS of 80 (one layer is
#: 855.64 M parameters, 1.711 GB in bf16; the embedding and untied head
#: 2.10 B, 4.20 GB: 80 layers would be 141.1 GB, 32 are 59.0 GB of the
#: card's 80), SERVE_BATCH requests of its 256 vision positions and
#: INTERNVL_TEXT tokens (a 2048-position prefill through flash), then
#: INTERNVL_NEW greedy tokens; whisper-tiny at its full size generates
#: WHISPER_NEW tokens after a WHISPER_PROMPT-token prompt fed token by
#: token (its max_seq of 448 caps prompt + new tokens).
INTERNVL_LAYERS = 32
INTERNVL_TEXT, INTERNVL_NEW = 1792, 128
WHISPER_PROMPT, WHISPER_NEW = 64, 128
#: One InternVL2-76B prefill layer: GQA, 64 query heads over 8 KV heads
#: of 128, bf16, causal, 2048 positions.
INTERNVL_FLASH_CASE = ("internvl2-76b prefill B2 H64/8 S2048 D128 bf16 "
                       "causal", 2, 64, 8, 2048, 128, "bfloat16",
                       dict(causal=True))


def serve_internvl2(torch, np) -> dict:
    """Phase 13 (b): InternVL2-76B at its published widths, its depth cut
    to INTERNVL_LAYERS, bf16: prefill of the vision prefix and the prompt
    (flash once a layer), greedy decode (no launch), and decode held
    against a re-prefill of everything decode was fed."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import api

    full = configs.get("internvl2_76b")
    cfg = dataclasses.replace(full, n_layers=INTERNVL_LAYERS)
    t0 = time.perf_counter()
    model = api.init(cfg, seed=SEED, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"phase 13 internvl2: {cfg.n_layers} of {full.n_layers} layers, "
          f"init {time.perf_counter() - t0:.1f}s")
    check_params(model, cfg)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    b, p, s0, n_new = (SERVE_BATCH, cfg.vision_tokens, INTERNVL_TEXT,
                       INTERNVL_NEW)
    max_s = p + s0 + n_new
    rng = np.random.default_rng(SEED)
    vision = torch.from_numpy(rng.standard_normal(
        (b, p, cfg.d_model))).to(torch.bfloat16).cuda()
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s0))).cuda()
    inputs = {"vision_embeds": vision}
    api.prefill(model, cfg, dict(inputs, tokens=prompt),
                api.init_caches(model, cfg, b, max_s))       # warm-up
    profiled = {"prefill": device_time_by_op(
        torch, f"internvl2 prefill {b}x({p}+{s0})", lambda: api.prefill(
            model, cfg, dict(inputs, tokens=prompt),
            api.init_caches(model, cfg, b, max_s)), phase=13)}

    ops.reset_launch_counts()
    logits, caches, prefill_ms, flash_ms, n_flash = timed_prefill(
        torch, api, model, cfg, prompt, api.init_caches(model, cfg, b, max_s),
        inputs)
    launches = ops.launch_counts()
    print(f"phase 13 internvl2 prefill {b}x({p}+{s0}): {prefill_ms:.1f} ms, "
          f"flash_attention {flash_ms:.1f} ms in {n_flash} launches "
          f"({flash_ms / prefill_ms:.1%} of prefill); launches {launches}")
    if launches["flash_attention"] != cfg.n_layers or \
            logits.shape != (b, p + s0, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()) or \
            caches.kv.length != p + s0:
        raise AssertionError("internvl2 prefill: flash not once per layer, "
                             "or bad logits or cache length")
    # A step on the prefill's cache, its result dropped: it writes K/V at
    # position p + s0, which the first real step writes again.
    api.decode_step(model, cfg, prompt[:, -1:], caches)     # warm-up
    profiled["decode step"] = device_time_by_op(
        torch, "internvl2 decode step", lambda: api.decode_step(
            model, cfg, prompt[:, -1:], caches), phase=13)
    dec, generated, caches, decode_ms = greedy_decode(
        torch, api, model, cfg, logits, caches, n_new)
    del logits
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    aten = aten_calls_per_decode_step(torch, api, model, cfg, b)
    print(f"phase 13 internvl2 decode {n_new} tokens x {b}: {decode_ms:.2f} "
          f"ms/token (bound {bound_ms:.2f} ms: {weight_bytes / 1e9:.2f} GB "
          f"of weights over {HBM_BYTES_PER_S / 1e12:.2f} TB/s; {aten} ATen "
          f"calls a step); launches {ops.launch_counts()}")
    if ops.launch_counts() != launches or caches.kv.length != max_s:
        raise AssertionError("internvl2 decode launched a kernel or lost a "
                             "token")
    del caches

    # Re-prefill of the prefix, the prompt and the tokens decode was fed:
    # p + s0 + n_new = 2176 positions, a multiple of 128, so flash again.
    seq = torch.cat([prompt, generated[:, :-1]], dim=1)
    logits2, _, reprefill_ms, _, _ = timed_prefill(
        torch, api, model, cfg, seq, api.init_caches(model, cfg, b, max_s),
        inputs)
    launches = ops.launch_counts()
    print(f"phase 13 internvl2 re-prefill {b}x({p}+{s0 + n_new}): "
          f"{reprefill_ms:.1f} ms; launches {launches}")
    if launches["flash_attention"] != 2 * cfg.n_layers:
        raise AssertionError("internvl2 re-prefill did not run flash once "
                             "per layer")
    if not decode_agrees(torch, dec, generated, logits2[:, p + s0 - 1:]):
        raise AssertionError("internvl2 decode disagrees with the "
                             "re-prefill")
    del model, logits2
    return {"prefill_ms": prefill_ms, "flash_ms": flash_ms,
            "flash_launches_per_prefill": n_flash,
            "decode_ms_per_token": decode_ms, "decode_bound_ms": bound_ms,
            "aten_calls_a_step": aten, "reprefill_ms": reprefill_ms,
            "launches": launches, "profile": profiled}


def serve_whisper(torch, np) -> dict:
    """Phase 13 (c): whisper-tiny at its full size, bf16: the encoder's
    time, ``serve.decode.generate`` with the frames twice (identical
    tokens, finite logits, no kernel launch), and the decode logits held
    against the teacher-forced ``api.forward_train`` of the same tokens."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import api, encdec
    from repro_torch.serve.decode import generate

    cfg = configs.get("whisper_tiny")
    model = api.init(cfg, seed=SEED, device="cuda", dtype=torch.bfloat16)
    check_params(model, cfg)
    b, s0, n_new = SERVE_BATCH, WHISPER_PROMPT, WHISPER_NEW
    max_s = s0 + n_new + 1
    rng = np.random.default_rng(SEED)
    frames = torch.from_numpy(rng.standard_normal(
        (b, cfg.encoder_seq, cfg.d_model))).to(torch.bfloat16).cuda()
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s0))).cuda()
    inputs = {"frames": frames}
    ops.reset_launch_counts()
    with torch.no_grad():
        encoder_ms = time_ms(torch, lambda: encdec.encode(model, cfg,
                                                          frames), reps=5)
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    step, runs = api.decode_step, []

    def checked_step(*args, **kw):   # every step's logits finite, kept
        logits, caches = step(*args, **kw)
        finite.logical_and_(torch.isfinite(logits).all())
        runs[-1]["logits"].append(logits[:, 0])
        return logits, caches

    api.decode_step = checked_step
    try:
        for _ in range(2):
            runs.append({"logits": []})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[-1]["tokens"] = generate(model, cfg, prompt, max_new=n_new,
                                          max_s=max_s, batch_inputs=inputs)
            torch.cuda.synchronize()
            runs[-1]["ms"] = ((time.perf_counter() - t0) * 1e3
                              / (s0 - 1 + n_new))
    finally:
        api.decode_step = step
    out, dec = runs[0]["tokens"], torch.stack(runs[0]["logits"], dim=1)
    same = torch.equal(out, runs[1]["tokens"])
    aten = aten_calls_per_decode_step(torch, api, model, cfg, b, inputs)
    print(f"phase 13 whisper encoder {b}x{cfg.encoder_seq} frames: "
          f"{encoder_ms:.3f} ms; generate {b}x{s0} prompt (teacher-forced) "
          f"+ {n_new} tokens, twice: {runs[0]['ms']:.2f}, "
          f"{runs[1]['ms']:.2f} ms/token over {s0 - 1 + n_new} steps, the "
          f"encoder run once in init_caches ({aten} ATen calls a step); "
          f"tokens identical: {same}; logits finite: {bool(finite)}; "
          f"launches {ops.launch_counts()}")
    if not same or not bool(finite) or out.shape != (b, s0 + n_new) or \
            any(ops.launch_counts().values()):
        raise AssertionError("whisper: the two generations differ, a logit "
                             "is not finite, or a kernel launched")
    # Decode against the teacher-forced forward of the 192 tokens: step i
    # (fed token i) predicts position i + 1; greedy tokens from s0 on.
    ref, _ = api.forward_train(model, cfg, {"tokens": out, **inputs})
    v, n = cfg.vocab, dec.shape[1]
    ref = ref[:, :n, :v]
    prompt_err = float((dec[:, :s0 - 1, :v] - ref[:, :s0 - 1]).abs().max())
    print(f"phase 13 whisper decode vs teacher-forced forward over the "
          f"prompt's {s0 - 1} positions: max|d|={prompt_err:.4f} (tol "
          f"{DECODE_LOGIT_TOL}); over the {n_new} generated:")
    if prompt_err > DECODE_LOGIT_TOL or not decode_agrees(
            torch, dec[:, s0 - 1:, :v], out[:, s0:], ref[:, s0 - 1:]):
        raise AssertionError("whisper decode disagrees with the "
                             "teacher-forced forward")
    del model
    return {"encoder_ms": encoder_ms,
            "decode_ms_per_token": [r["ms"] for r in runs],
            "aten_calls_a_step": aten, "prompt_max_abs_err": prompt_err}


def serve_encdec_vlm(torch, np) -> dict:
    """Phase 13: flash at InternVL2-76B's prefill shape, then InternVL2-76B
    (published widths, depth cut) and whisper-tiny served on the card;
    each model's peak reserved memory counted from its load."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    flash = check_flash(torch, np, cases=(INTERNVL_FLASH_CASE,))
    flash["check_launches"] = ops.launch_counts()["flash_attention"]
    release(torch)
    served = {}
    for name, serve in (("internvl2", serve_internvl2),
                        ("whisper", serve_whisper)):
        torch.cuda.reset_peak_memory_stats()
        served[name] = serve(torch, np)
        release(torch)
        peak = torch.cuda.max_memory_reserved()
        served[name]["peak_reserved_gb"] = peak / 1e9
        print(f"phase 13 {name}: peak reserved {peak / 1e9:.2f} GB "
              f"({peak / 2 ** 30:.2f} GiB)")
    wall = time.perf_counter() - t0
    print(f"phase 13 took {wall:.1f}s")
    return {"flash": flash, "seconds": wall, **served}


def _read_atlas(path: Path, shard=None) -> list:
    """The records of the ``cuda`` backend's atlas at ``path``, opened as
    a resume would open it (its header must match this process)."""
    from repro_torch.core.fingerprint import HardwareFingerprint
    from repro_torch.core.sweep import AnomalyAtlas

    head = json.loads(path.read_text().splitlines()[0])
    fp = HardwareFingerprint.from_dict(head["fingerprint"])
    return AnomalyAtlas(path, fp, head["spec"], head["threshold"],
                        shard=shard).records()


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
            # A matrix kernel's batched instance (its template flag
            # BATCHED) is named "batched".
            loop = "batched " if (tiled or square or fused) and "Lb1E" in fn \
                else ""
            name = (f"flash_kernel<f32,{f32.group(1)}> " if f32 else
                    f"flash_tc_kernel<bf16,{tc.group(1)}> " if tc else
                    f"{tiled.group(1)}_kernel<{tiled.group(2)}x"
                    f"{tiled.group(3)}> {loop}" if tiled else
                    f"syrk_kernel<{square.group(1)}x{square.group(1)}> {loop}"
                    if square else
                    f"gemm_syrk_kernel<bl{fused.group(1)}> {loop}" if fused
                    else "split_sum_kernel " if "split_sum_kernel" in fn else
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


#: Phase 12: the points at which every backend's results are held
#: against the float64 BLAS ones, each on the same seeded operands.
PROTOCOL_POINTS = (("aatb", (1200, 800, 400)),
                   ("abcd", (400, 1200, 400, 1200, 400)))
#: max|got - blas| <= limit·max|blas| for float64 (numpy, torch on the
#: card), and for torch in bfloat16: inputs, each intermediate and the
#: output are rounded to bf16 (2^-9 relative each) while the products
#: accumulate in float32, so the largest error seen on the CPU was
#: 5.1e-3·max|value| (PERF.md §2); 2^-6 leaves three times that.
PROTOCOL_F64_TOL = 1e-10
PROTOCOL_BF16_TOL = 2 ** -6
#: Phase 12's sweeps: (family, axis values), phase 4's grids.
PROTOCOL_SWEEPS = (("aatb", (400, 800, 1200)), ("abcd", (400, 1200)))
#: Experiment 1 on every engine: the same 50 points (one more anomaly
#: than samples, so no run stops early).
PROTOCOL_EXPERIMENT1 = dict(box=(20, 600), n_anomalies=51, max_samples=50,
                            seed=0)


def host_cpu() -> str:
    """The host's CPU, thread count and scipy's BLAS: where blas and numpy
    run. A sandbox may report the model name as "unknown": then the
    vendor, family and model numbers stand for it."""
    fields = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = fields.get("model name", "unknown")
    if model == "unknown":
        model = " ".join(f"{k} {fields[k]}" for k in
                         ("vendor_id", "cpu family", "model")
                         if k in fields) or "unknown CPU"
    import scipy

    blas = scipy.show_config(mode="dicts")["Build Dependencies"]["blas"]
    return (f"{model}, {os.cpu_count()} threads, {blas['name']} "
            f"{blas['version']}")


def _protocol_agreement(torch, np, host: str) -> None:
    """Phase 12 (a): every algorithm at PROTOCOL_POINTS on blas and numpy
    (float64, host), torch on the card in float64 and bfloat16, and cuda
    (float32), on the same seeded operands, held against blas."""
    from repro_torch.core.backends import get_backend
    from repro_torch.core.expressions import get_spec

    blas = get_backend("blas", reps=1, flush_cache=False, seed=SEED)
    oracle = get_backend("numpy", reps=1, flush_cache=False, seed=SEED)
    on_card = {"torch float64": get_backend("torch", dtype="float64",
                                            seed=SEED),
               "torch bfloat16": get_backend("torch", dtype="bfloat16",
                                             seed=SEED),
               "cuda float32": get_backend("cuda", seed=SEED)}

    def limit(label, scale):
        if label == "torch bfloat16":
            return PROTOCOL_BF16_TOL * scale
        if label == "cuda float32":
            return 1e-3 + 1e-4 * scale
        return PROTOCOL_F64_TOL * scale

    for name, point in PROTOCOL_POINTS:
        for alg in get_spec(name).algorithms(point):
            t0 = time.perf_counter()
            want = np.asarray(blas.execute(alg, blas.make_operands(alg)))
            blas_s = time.perf_counter() - t0
            scale = float(np.abs(want).max())
            got = {"numpy float64": np.asarray(
                oracle.execute(alg, oracle.make_operands(alg)))}
            for label, backend in on_card.items():
                out = backend.execute(alg, backend.make_operands(alg))
                got[label] = out.double().cpu().numpy()
            errs = {label: float(np.abs(g - want).max())
                    for label, g in got.items()}
            print(f"phase 12 agreement {name}{point} {alg.name}: max|value| "
                  f"{scale:.4e}, blas {blas_s * 1e3:.1f} ms eager on the "
                  f"host ({host}); max|d| vs blas " + ", ".join(
                      f"{label} {e:.3e} (limit {limit(label, scale):.3e})"
                      for label, e in errs.items()))
            bad = [label for label, e in errs.items()
                   if not e <= limit(label, scale)
                   or got[label].shape != want.shape]
            if bad:
                raise AssertionError(f"{name}{point} {alg.name}: {bad} "
                                     f"disagree with blas")


def _protocol_compare(torch, atlas_dir: Path, phase4: dict,
                      host: str) -> None:
    """Phase 12 (b): ``sweep --compare-backends blas,cuda`` over phase 4's
    aatb and abcd grids, flush on, into a fresh atlas directory (so the
    cuda side measures, and launches exactly what phase 4 launched)."""
    from repro_torch.core import sweep as sweep_mod
    from repro_torch.kernels import ops

    for name, axis in PROTOCOL_SWEEPS:
        ops.reset_launch_counts()
        text, _ = run_cli(sweep_mod.main, [
            "--compare-backends", "blas,cuda", "--expr", name, "--grid",
            ",".join(map(str, axis)), "--reps", str(REPS), "--seed",
            str(SEED), "--atlas-dir", str(atlas_dir / f"compare-{name}"),
            "--quiet"])
        got = ops.launch_counts()
        rows = dict(re.findall(r"\[(blas|cuda)\]: (points=.*)", text))
        differs = re.search(r"fastest-differs=(\d+)", text)
        paths = dict(re.findall(r"atlas\[(blas|cuda)\] written to (\S+)",
                                text))
        fps = {k: json.loads(Path(v).read_text().splitlines()[0])[
            "fingerprint"] for k, v in paths.items()}
        print(f"phase 12 compare {name} over {axis}: blas {rows.get('blas')} "
              f"(host: {host}); cuda {rows.get('cuda')}; fastest-differs="
              f"{differs and differs.group(1)}; fingerprints blas "
              f"{fps.get('blas')}, cuda {fps.get('cuda')}")
        want = {k: phase4[name].get(k, 0) for k in got}
        print(f"phase 12 compare {name} cuda launches {got} (measured in a "
              f"fresh atlas, not resumed: must equal phase 4's {want})")
        if set(rows) != {"blas", "cuda"} or differs is None or \
                len(fps) != 2 or fps["blas"] == fps["cuda"]:
            raise AssertionError(f"compare blas,cuda on {name} printed "
                                 f"{rows}, {fps}")
        if any("measured=0 " in r for r in rows.values()):
            raise AssertionError(f"compare {name} resumed an atlas")
        if got != want:
            raise AssertionError(f"compare {name}: cuda launched {got}, "
                                 f"not {want}")


def _protocol_calibrate(torch, profile_dir: Path, host: str) -> None:
    """Phase 12 (c): calibrate blas (host) and torch in bfloat16 (card)
    on aatb's calls; cuda in bfloat16 must exit non-zero."""
    import platform

    from repro_torch.core import calibrate as cal

    os.environ["REPRO_PROFILE_DIR"] = str(profile_dir)
    grid = ",".join(map(str, PROTOCOL_SWEEPS[0][1]))
    want = {"blas": {"backend": "blas", "device": platform.machine(),
                     "dtype": "float64"},
            "torch": {"backend": "torch",
                      "device": torch.cuda.get_device_name(0),
                      "dtype": "bfloat16"}}
    for backend, extra in (("blas", []), ("torch", ["--dtype", "bfloat16"])):
        text, _ = run_cli(cal.main, ["--backend", backend, "--expr", "aatb",
                                     "--grid", grid, "--reps", str(REPS),
                                     "--seed", str(SEED), "--quiet"] + extra)
        path = re.search(r"profile written to (\S+)", text).group(1)
        fp = json.loads(Path(path).read_text())["fingerprint"]
        print(f"phase 12 calibrate {backend}: fingerprint {fp}"
              + (f" (host: {host})" if backend == "blas" else ""))
        if fp != want[backend]:
            raise AssertionError(f"calibrate {backend} wrote {fp}, not "
                                 f"{want[backend]}")
    try:
        rc = cal.main(["--backend", "cuda", "--dtype", "bfloat16", "--expr",
                       "aatb", "--grid", grid])
    except SystemExit as e:
        rc = e.code
    print(f"phase 12 calibrate --backend cuda --dtype bfloat16: exit {rc}")
    if not rc:
        raise AssertionError("calibrate --backend cuda --dtype bfloat16 "
                             "did not refuse")


def _protocol_experiments(torch, atlas_dir: Path, profile_dir: Path,
                          host: str) -> None:
    """Phase 12 (d): Experiment 1 on blas (serial, and two worker
    processes) and on cuda (the devices engine): the same 50 points;
    then the Experiment 3 driver at CI scale on cuda."""
    import functools

    from repro_torch.core.backends import make_backend
    from repro_torch.core.experiments import experiment1_random_search
    from repro_torch.core.expressions import get_spec
    from repro_torch.core.profile_store import current_fingerprint
    from repro_torch.core.sweep import AnomalyAtlas, atlas_path

    spec = get_spec("aatb")
    # One repetition on blas: this part checks that the engines draw the
    # same points; (b) measures the map at REPS.
    runs = (
        ("blas serial", "blas",
         dict(runner=make_backend("blas", reps=1, seed=SEED))),
        ("blas process x2", "blas",
         dict(backend="process", shards=2, runner_factory=functools.partial(
             make_backend, "blas", reps=1, seed=SEED))),
        ("cuda devices", "cuda",
         dict(backend="devices", exec_backend="cuda", device="cuda")))
    drawn, samples = {}, {}
    for label, backend, kw in runs:
        fp = current_fingerprint(backend, "float64" if backend == "blas"
                                 else "float32")
        directory = atlas_dir / label.replace(" ", "-")
        with AnomalyAtlas(atlas_path(spec.name, fp, 0.10, directory), fp,
                          spec.name, 0.10) as atlas:
            t0 = time.perf_counter()
            res = experiment1_random_search(spec, atlas=atlas,
                                            **PROTOCOL_EXPERIMENT1, **kw)
            wall = time.perf_counter() - t0
            drawn[label] = sorted(r.point for r in atlas.records())
        samples[label] = res.samples
        print(f"phase 12 experiment 1 {label}: samples={res.samples} "
              f"anomalies={len(res.anomalies)} in {wall:.1f}s"
              + (f" (host: {host})" if backend == "blas" else ""))
    if len({tuple(p) for p in drawn.values()}) != 1 or \
            set(samples.values()) != {PROTOCOL_EXPERIMENT1["max_samples"]}:
        raise AssertionError(f"the three engines drew different points: "
                             f"samples {samples}")

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_EXEC_BACKEND="cuda", REPRO_BENCH_SCALE="ci",
               REPRO_ATLAS_DIR=str(atlas_dir / "experiment3"),
               REPRO_PROFILE_DIR=str(profile_dir / "experiment3"))
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.experiment3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    row = re.search(r"^exp3_AATB_recall,([^,]+),(.*)$", done.stdout, re.M)
    print(f"phase 12 experiment3 driver (cuda, CI scale): exit "
          f"{done.returncode} in {wall:.1f}s; row "
          f"{row and row.group(0)}")
    print("\n".join(done.stderr.strip().splitlines()[-6:]))
    if done.returncode or row is None:
        raise AssertionError(f"the experiment3 driver failed: "
                             f"{done.stderr[-2000:]}")
    print(f"phase 12 experiment 3 recall {float(row.group(1)):.1f} %, "
          f"{row.group(2)}")


def paper_protocol(torch, np, phase4: dict) -> dict:
    """Phase 12: the paper's float64 BLAS protocol beside the card's
    backends. Returns the kernel launches of parts (b)-(d)."""
    from repro_torch.core.backends import register_torch_backends
    from repro_torch.kernels import ops

    register_torch_backends()
    host = host_cpu()
    print(f"phase 12 host: {host}")
    t0 = time.perf_counter()
    _protocol_agreement(torch, np, host)
    print(f"phase 12 (a) agreement: {time.perf_counter() - t0:.1f}s")
    launches = dict.fromkeys(ops.launch_counts(), 0)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-protocol-") as d:
        root = Path(d)
        for part, fn, args in (
                ("(b) compare", _protocol_compare, (root / "atlas", phase4)),
                ("(c) calibrate", _protocol_calibrate, (root / "profiles",)),
                ("(d) experiments", _protocol_experiments,
                 (root / "atlas", root / "profiles"))):
            t1 = time.perf_counter()
            ops.reset_launch_counts()
            fn(torch, *args, host)
            launches = _add(launches, ops.launch_counts())
            print(f"phase 12 {part}: {time.perf_counter() - t1:.1f}s")
    print(f"phase 12 kernel launches: {launches}; phase 12 took "
          f"{time.perf_counter() - t0:.1f}s")
    idle = [k for k in ("gemm", "syrk", "symm", "chain_gemm")
            if not launches[k]]
    if idle:
        raise AssertionError(f"phase 12 never launched {idle}")
    return launches


#: Phase 14: training on the card. The train step differentiates a bf16
#: working copy (fp32 masters and moments), random weights from SEED,
#: ``SyntheticLM`` data from SEED, peak lr TRAIN_LR after TRAIN_WARMUP
#: warm-up steps, cosine to the run's last step. Mamba2-370M takes
#: MAMBA_TRAIN_BATCH requests of TRAIN_SEQ tokens a step (AdamW, then
#: Muon, then a crash at RESUME_FAIL_AT and a supervised resume from the
#: save at RESUME_SAVE_EVERY), Zamba2-1.2B ZAMBA_TRAIN_BATCH.
TRAIN_SEQ, TRAIN_LR, TRAIN_WARMUP = 2048, 1e-3, 2
MAMBA_TRAIN_BATCH, MAMBA_TRAIN_STEPS, MUON_TRAIN_STEPS = 2, 12, 6
RESUME_STEPS, RESUME_SAVE_EVERY, RESUME_FAIL_AT = 8, 4, 5
ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_STEPS = 1, 4
#: Zamba2-1.2B's peak lr. From random weights, Adam's first updates
#: overshoot at 1e-4 and above (``train_probe.py`` on an H100, seeds 0–2:
#: the loss rises by up to 6.2 nats, in float32 and through the dense
#: attention alike, and is lowest an eighth to a half of the way along
#: the update); at 3e-5 it falls from step 1 on, 10.76 → 9.12 on seed 0.
ZAMBA_TRAIN_LR = 3e-5
#: Mamba2-370M's per-block activation checkpointing (``ModelConfig.remat``)
#: at 2 × 2048 tokens: without it a step's peak reserved memory is 64 GB
#: on an H100, below the 70 GB past which phase 14 would take ``"full"``.
MAMBA_REMAT = "none"
#: Zamba2-1.2B's shared attention block at TRAIN_SEQ positions: B 1, 32
#: heads of 64 (MHA), causal, window 4096 (wider than the sequence).
CHUNKED_SHAPE = (1, 32, TRAIN_SEQ, 64, 4096)
#: max|chunked − dense| ≤ limit · max|dense| for (out, dq, dk, dv): bf16
#: at 2**-6, as flash is held; float32 out and dq at 1e-4. The float32
#: backward rounds each key block's dk and dv to bf16, as the reference
#: does (None here): those hold element by element within half a bf16
#: ulp of the dense value, |chunked − dense| ≤ 2**-8·|dense| +
#: CHUNKED_ATOL, 3× the largest excess measured on an H100 (dk, 3.80e-6).
CHUNKED_TOL = {"float32": (1e-4, 1e-4, None, None),
               "bfloat16": (2 ** -6,) * 4}
CHUNKED_ATOL = 1.15e-5
#: The resumed run's losses and final ``final_norm.g`` against an
#: uninterrupted run: the reference's test tolerance.
RESUME_TOL = dict(rtol=1e-5, atol=1e-6)


def check_chunked(torch, np) -> dict:
    """Phase 14 (a): chunked attention with its own backward against
    autograd through the dense attention at Zamba2's shared-block shape,
    float32 and bf16; peak memory of each; a planted fault (one key
    block's dv dropped) must be rejected."""
    from repro_torch.models import attention

    b, h, s, d, window = CHUNKED_SHAPE
    cfg = attention.AttnConfig(d_model=h * d, n_heads=h, n_kv_heads=h,
                               head_dim=d, window=window)
    rng = np.random.default_rng(SEED)
    result = {}
    for dtype in ("float32", "bfloat16"):
        q, k, v, g = (torch.from_numpy(rng.standard_normal((b, s, h, d))
                                       * scale).to(getattr(torch, dtype))
                      .cuda() for scale in (QK_SCALE, QK_SCALE, 1.0, 1.0))
        runs = {}
        for name, fn in (("chunked", attention.chunked_attention),
                         ("dense", attention._dense_attention)):
            def step(fn=fn):
                qs, ks, vs = (t.detach().requires_grad_(True)
                              for t in (q, k, v))
                out = fn(cfg, qs, ks, vs)
                out.backward(g)
                return [t.detach().float()
                        for t in (out, qs.grad, ks.grad, vs.grad)]
            step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got = step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            runs[name] = (got, peak, time_ms(torch, step, reps=3, warmup=1))
        (got, peak, ms), (want, dense_peak, dense_ms) = runs["chunked"], \
            runs["dense"]
        planted = got[3].clone()
        planted[:, 512:1024] = 0          # key block 1's dv dropped
        errs, ok = _chunked_errors(dtype, got, want)
        planted_err, planted_ok = _chunked_errors(dtype, got[:3] + [planted],
                                                  want)
        print(f"phase 14 (a) chunked attention {dtype} (B {b}, {h} heads of "
              f"{d}, S {s}, causal, window {window}), forward + backward: "
              f"{_chunked_report(dtype, errs)} {'ok' if ok else 'FAIL'}; "
              f"planted dv block dropped: dv {planted_err[3]:.3e} "
              f"{'ACCEPTED' if planted_ok else 'rejected'}; "
              f"peak allocated chunked {peak / 2 ** 20:.0f} MiB, dense "
              f"{dense_peak / 2 ** 20:.0f} MiB; {ms:.2f} ms, dense "
              f"{dense_ms:.2f} ms")
        if not ok or planted_ok or peak >= dense_peak:
            raise AssertionError(f"chunked attention {dtype}: disagrees with "
                                 f"the dense route, accepts the planted "
                                 f"fault, or holds more memory")
        result[dtype] = {"errors": errs, "planted_err": planted_err[3],
                         "peak_bytes": peak, "dense_peak_bytes": dense_peak,
                         "ms": ms, "dense_ms": dense_ms}
    return result


def _chunked_errors(dtype: str, got, want):
    """(out, dq, dk, dv) of the chunked route against the dense one →
    (errors, all within CHUNKED_TOL): max|d| / max|dense| where a limit
    is given, else the largest excess of |d| over half a bf16 ulp of the
    dense value (2**-8·|dense|), held at CHUNKED_ATOL."""
    errs, ok = [], True
    for a, w, lim in zip(got, want, CHUNKED_TOL[dtype]):
        d = (a - w).abs()
        if lim is None:
            errs.append(float((d - 2 ** -8 * w.abs()).max()))
            ok &= errs[-1] <= CHUNKED_ATOL
        else:
            errs.append(float(d.max() / w.abs().max()))
            ok &= errs[-1] <= lim
    return errs, ok


def _chunked_report(dtype: str, errs) -> str:
    parts = [f"{name} {e:.3e} (limit {lim:g} of max|dense|)"
             if lim is not None else
             f"{name} {e:.3e} (over half a bf16 ulp, limit {CHUNKED_ATOL:g})"
             for name, e, lim in zip(("out", "dq", "dk", "dv"), errs,
                                     CHUNKED_TOL[dtype])]
    return "max|chunked - dense|: " + ", ".join(parts)


def _train(torch, cfg, batch: int, steps: int, label: str,
           after_step=None, lines=None, lr: float = TRAIN_LR,
           phase: int = 14, **kw):
    """``train_loop.train`` on the card; prints each step (with what
    ``after_step(row)`` adds to its row) and the loop's own lines
    (restores, saves), which it appends to ``lines`` → (state, step
    rows)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import loop as train_loop

    rows = []
    lines = [] if lines is None else lines

    def on_step(step, metrics, wall):
        rows.append(dict(step=step, wall_ms=wall * 1e3, **metrics))
        extra = after_step(rows[-1]) if after_step else ""
        print(f"phase {phase} {label} step {step}: loss "
              f"{metrics['loss']:.4f} "
              f"lr {metrics['lr']:.3e} grad_norm {metrics['grad_norm']:.4f} "
              f"{wall * 1e3:.1f} ms{extra}")

    def log(msg):
        lines.append(msg)
        if not msg.startswith("[train] step="):
            print(f"phase {phase} {label} {msg}")

    source = SyntheticLM(cfg.vocab, TRAIN_SEQ, batch, seed=SEED)
    state = train_loop.train(cfg, source, steps, peak_lr=lr,
                             warmup=TRAIN_WARMUP, seed=SEED, device="cuda",
                             log_every=steps, log_fn=log, on_step=on_step,
                             **kw)
    return state, rows


def _falls(rows, label: str) -> None:
    """Every loss and grad norm finite, and the last loss below the first."""
    import math

    values = [r[k] for r in rows for k in ("loss", "grad_norm")]
    if not all(math.isfinite(x) for x in values) or \
            rows[-1]["loss"] >= rows[0]["loss"]:
        raise AssertionError(f"{label}: a loss or grad norm is not finite, "
                             f"or the loss did not fall")


def _tokens_per_s(rows, batch: int) -> float:
    """Tokens a second over the steps after the first (which pays the
    allocator's and cuBLAS's first calls): the median step."""
    walls = sorted(r["wall_ms"] for r in rows[1:])
    return batch * TRAIN_SEQ / (walls[len(walls) // 2] / 1e3)


def _state_reckoning(cfg) -> str:
    """The training state's bytes from the parameter count: fp32 masters,
    two fp32 moments, and the bf16 working copy and its gradients."""
    from repro_torch.models import api

    n = sum(p.numel() for p in api.family_module(cfg).init(
        cfg, None, device="meta").parameters())
    return (f"{n / 1e6:.1f} M parameters: masters {4 * n / 1e9:.2f} GB + "
            f"moments {8 * n / 1e9:.2f} GB + bf16 working copy and gradients "
            f"{4 * n / 1e9:.2f} GB = {16 * n / 1e9:.2f} GB")


def train_mamba2(torch, np) -> dict:
    """Phase 14 (b): Mamba2-370M at full width and depth, AdamW, through
    ``train_loop.train``; one more step under ``torch.profiler``."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import ssm
    from repro_torch.train import train_step as ts

    cfg = dataclasses.replace(configs.get("mamba2_370m"), remat=MAMBA_REMAT)
    b = MAMBA_TRAIN_BATCH
    pick = ssm.select_ssd_mode(TRAIN_SEQ, cfg.ssm.d_state, cfg.ssm.head_dim,
                               cfg.ssm.chunk, heads=cfg.ssm.n_heads)
    print(f"phase 14 (b) mamba2 {b} x {TRAIN_SEQ} tokens a step, remat "
          f"{cfg.remat!r}; select_ssd_mode picks {pick}; state reckoned: "
          f"{_state_reckoning(cfg)}")
    torch.cuda.reset_peak_memory_stats()
    state, rows = _train(torch, cfg, b, MAMBA_TRAIN_STEPS, "(b) mamba2")
    _falls(rows, "mamba2 AdamW")
    peak = torch.cuda.max_memory_reserved()
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        cfg.vocab, TRAIN_SEQ, b, seed=SEED).batch_at(MAMBA_TRAIN_STEPS)
        .items()}
    t0 = time.perf_counter()
    profiled = device_time_by_op(
        torch, "mamba2 train step", lambda: ts.train_step(
            state, batch, cfg=cfg, peak_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
            total_steps=MAMBA_TRAIN_STEPS + 1), top=8, phase=14)
    tps = _tokens_per_s(rows, b)
    step_ms = b * TRAIN_SEQ / tps * 1e3
    profiled["share_of_step"] = profiled["device_ms"] / step_ms
    print(f"phase 14 (b) mamba2: {tps:.0f} tokens/s (median step "
          f"{step_ms:.1f} ms; the profiled step's device time is "
          f"{profiled['share_of_step']:.0%} of it; profiling took "
          f"{time.perf_counter() - t0:.1f}s); peak reserved "
          f"{peak / 1e9:.2f} GB; loss {rows[0]['loss']:.4f} -> "
          f"{rows[-1]['loss']:.4f}")
    return {"rows": rows, "tokens_per_s": tps, "peak_reserved_gb": peak / 1e9,
            "remat": cfg.remat, "ssd_mode": pick, "profile": profiled}


def train_mamba2_muon(torch, np) -> dict:
    """Phase 14 (c): Mamba2-370M with Muon; ``plan_ns_mode``'s pick and the
    FLOPs of one Newton–Schulz (5 iterations) per distinct matrix shape,
    and the Newton–Schulz ms of each step (CUDA events around each call)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.perfmodel import AnalyticalTPUProfile
    from repro_torch.models import api
    from repro_torch.optim import leaves, muon

    cfg = dataclasses.replace(configs.get("mamba2_370m"), remat=MAMBA_REMAT)
    params = dict(api.family_module(cfg).init(cfg, None, device="meta")
                  .named_parameters())
    shapes = {}
    for names in muon.matrices(params).values():
        shape = leaves.reference_shape(names[0], params[names[0]],
                                       len(names))
        shapes.setdefault(tuple(sorted(shape)), []).append(names[0])
    picks = {}
    for (m, k), names in sorted(shapes.items()):
        pick = muon.plan_ns_mode(m, k)
        flops = muon.NS_STEPS * sum(c.flops for c in muon.ns_algorithm_calls(
            pick, m, k))
        picks[f"{m}x{k}"] = pick
        print(f"phase 14 (c) muon NS on {m} x {k} ({len(names)} leaves, e.g. "
              f"{leaves.reference_name(names[0])}): plan_ns_mode picks {pick} "
              f"(flops: {muon.plan_ns_mode(m, k, 'flops')}, TPU model: "
              f"{muon.plan_ns_mode(m, k, profile=AnalyticalTPUProfile())}); "
              f"{flops / 1e9:.3f} GFLOP a step")
    events, ns_ms = [], []
    real = muon.newton_schulz

    def timed(x, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(x, *args, **kw)
        end.record()
        events.append((start, end))
        return out

    def ns_time(row):
        torch.cuda.synchronize()
        row["ns_ms"] = sum(a.elapsed_time(b) for a, b in events)
        events.clear()
        return f" (Newton-Schulz {row['ns_ms']:.2f} ms)"

    muon.newton_schulz = timed
    try:
        _, rows = _train(torch, cfg, MAMBA_TRAIN_BATCH, MUON_TRAIN_STEPS,
                         "(c) mamba2 muon", after_step=ns_time,
                         optimizer="muon")
    finally:
        muon.newton_schulz = real
    _falls(rows, "mamba2 Muon")
    return {"rows": rows, "ns_picks": picks,
            "tokens_per_s": _tokens_per_s(rows, MAMBA_TRAIN_BATCH)}


def _bits_equal(torch, a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    return a == b


_SAVED = re.compile(r"saved step (\d+): ([\d.]+) GB, host copy ([\d.]+) s, "
                    r"write ([\d.]+) s")


def crash_and_resume(torch, np) -> dict:
    """Phase 14 (d): Mamba2-370M, RESUME_STEPS steps saving every
    RESUME_SAVE_EVERY (keep 1), a crash at RESUME_FAIL_AT under
    ``Supervisor(RestartPolicy(max_restarts=1))``; the last save read back
    bit for bit; the resumed steps' losses and the final ``final_norm.g``
    against an uninterrupted run (RESUME_TOL)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.checkpoint import store
    from repro_torch.runtime.supervisor import RestartPolicy, Supervisor
    from repro_torch.train import train_step as ts

    cfg = dataclasses.replace(configs.get("mamba2_370m"), remat=MAMBA_REMAT)
    b = MAMBA_TRAIN_BATCH
    ref, ref_rows = _train(torch, cfg, b, RESUME_STEPS, "(d) uninterrupted")
    ref_g = ref.params["final_norm.g"].detach().clone()
    del ref
    release(torch)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as d:
        sup = Supervisor(RestartPolicy(max_restarts=1, backoff_s=0.0))
        lines, resumed = [], []

        def run(attempt):
            state, rows = _train(
                torch, cfg, b, RESUME_STEPS, f"(d) attempt {attempt}",
                lines=lines, ckpt_dir=d, save_every=RESUME_SAVE_EVERY,
                keep=1, fail_at_step=RESUME_FAIL_AT if attempt == 0 else None)
            resumed.extend(rows)     # the crashed attempt raised: not here
            return state

        try:
            state = sup.run(run)
        finally:
            print(f"phase 14 (d) supervisor: restarts {sup.restarts}, "
                  f"failures {[str(e) for e in sup.failures]}")
        like = ts.checkpoint_tree(state)
        back = store.restore(d, RESUME_STEPS, like)
        differ = [name for (name, x), (_, y) in zip(store.leaf_paths(like),
                                                    store.leaf_paths(back))
                  if not _bits_equal(torch, x, y)]
        on_disk = sorted(os.listdir(d))
    saves = [tuple(float(x) for x in m.groups())
             for m in map(_SAVED.search, lines) if m]
    ref_by_step = {r["step"]: r["loss"] for r in ref_rows}
    loss_ok = all(np.isclose(r["loss"], ref_by_step[r["step"]], **RESUME_TOL)
                  for r in resumed)
    g = state.params["final_norm.g"].detach()
    g_err = float((g - ref_g).abs().max())
    g_ok = bool(torch.allclose(g, ref_g, **RESUME_TOL))
    bitwise = all(r["loss"] == ref_by_step[r["step"]] for r in resumed) and \
        torch.equal(g, ref_g)
    for step, gb, copy_s, write_s in saves:
        print(f"phase 14 (d) save of step {step:.0f}: {gb:.3f} GB, host copy "
              f"{copy_s:.3f} s + write {write_s:.3f} s = "
              f"{gb / (copy_s + write_s):.2f} GB/s")
    print(f"phase 14 (d) resume: restarts {sup.restarts}; resumed steps "
          f"{[r['step'] for r in resumed]} losses vs uninterrupted "
          f"{[(round(r['loss'], 6), round(ref_by_step[r['step']], 6)) for r in resumed]}"
          f" {'ok' if loss_ok else 'FAIL'}; final_norm.g max|d| {g_err:.3e} "
          f"{'ok' if g_ok else 'FAIL'} (rtol {RESUME_TOL['rtol']:g}, atol "
          f"{RESUME_TOL['atol']:g}); bitwise repeat: {bitwise}; the save of "
          f"step {RESUME_STEPS} read back: {len(differ)} leaves differ; "
          f"left on disk {on_disk}")
    if sup.restarts != 1 or differ or not loss_ok or not g_ok or \
            [r["step"] for r in resumed] != list(range(RESUME_SAVE_EVERY,
                                                       RESUME_STEPS)):
        raise AssertionError("crash and resume: wrong restarts, a leaf read "
                             "back differs, or the resumed run diverges")
    return {"restarts": sup.restarts, "saves": saves, "bitwise": bitwise,
            "final_norm_g_max_abs_diff": g_err}


def train_zamba2(torch, np) -> dict:
    """Phase 14 (e): Zamba2-1.2B at full width and depth, AdamW; the shared
    block's attention takes the chunked path at every application."""
    from repro_torch import configs
    from repro_torch.models import attention, hybrid

    cfg = configs.get("zamba2_1p2b")
    b = ZAMBA_TRAIN_BATCH
    print(f"phase 14 (e) zamba2 {b} x {TRAIN_SEQ} tokens a step, peak lr "
          f"{ZAMBA_TRAIN_LR:g}, remat {cfg.remat!r}; state reckoned: "
          f"{_state_reckoning(cfg)}")
    calls = []
    real = attention.chunked_attention
    attention.chunked_attention = \
        lambda *args, **kw: calls.append(1) or real(*args, **kw)
    torch.cuda.reset_peak_memory_stats()
    try:
        _, rows = _train(torch, cfg, b, ZAMBA_TRAIN_STEPS, "(e) zamba2",
                         lr=ZAMBA_TRAIN_LR)
    finally:
        attention.chunked_attention = real
    _falls(rows, "zamba2 AdamW")
    peak = torch.cuda.max_memory_reserved()
    want = ZAMBA_TRAIN_STEPS * hybrid.n_shared_applications(cfg)
    print(f"phase 14 (e) zamba2: {_tokens_per_s(rows, b):.0f} tokens/s; "
          f"peak reserved {peak / 1e9:.2f} GB; chunked attention calls "
          f"{len(calls)} (want {want}); loss {rows[0]['loss']:.4f} -> "
          f"{rows[-1]['loss']:.4f}")
    if len(calls) != want:
        raise AssertionError("zamba2: the shared block missed the chunked "
                             "attention")
    return {"rows": rows, "peak_reserved_gb": peak / 1e9,
            "tokens_per_s": _tokens_per_s(rows, b), "chunked_calls": len(calls)}


def train_phase(torch, np) -> dict:
    """Phase 14: training on the card, (a)–(e); no hand-kernel launch."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    before = dict(ops.launch_counts())
    out = {"chunked": check_chunked(torch, np)}
    release(torch)
    for key, part in (("mamba2", train_mamba2),
                      ("muon", train_mamba2_muon),
                      ("resume", crash_and_resume),
                      ("zamba2", train_zamba2)):
        t1 = time.perf_counter()
        out[key] = part(torch, np)
        release(torch)
        print(f"phase 14 {key}: {time.perf_counter() - t1:.1f}s")
    after = dict(ops.launch_counts())
    print(f"phase 14 kernel launches: before {before}, after {after}")
    if after != before:
        raise AssertionError("phase 14 launched a hand kernel: the training "
                             "path must not reach one")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 14 took {out['seconds']:.1f}s")
    return out


#: Phase 15: decode tokens of the sharded Yi-9B (a), AdamW steps of the
#: sharded Mamba2-370M (b), whose losses must stay within
#: SHARDED_LOSS_RTOL (2⁻⁶) of phase 14 (b)'s first four (the same
#: weights, data and lr; bf16 products in another order), and the dry-run
#: cells (c) with their time limit.
SHARD_NEW = 32
SHARD_TRAIN_STEPS = 4
SHARDED_LOSS_RTOL = 2 ** -6
DRYRUN_CELLS = (("yi_9b", "train_4k", False), ("yi_9b", "prefill_32k", False),
                ("yi_9b", "decode_32k", False),
                ("olmoe_1b_7b", "train_4k", False),
                ("arctic_480b", "train_4k", False),
                ("mamba2_370m", "train_4k", True))
DRYRUN_TIMEOUT_S = 480


def start_dryrun(out_dir: Path) -> list:
    """Phase 15 (c): one dry-run process per cell, all started together,
    each on its own fake process group; → [(cell, process, output
    file)]."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        out = out_dir / f"{arch}-{shape}-{int(multi_pod)}.json"
        log = open(out.with_suffix(".log"), "w")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape,
               "--multi-pod", "on" if multi_pod else "off",
               "--out", str(out)]
        procs.append(((arch, shape, multi_pod), subprocess.Popen(
            cmd, env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT),
            out))
    return procs


def finish_dryrun(procs, smi: str) -> list:
    """Wait for the dry-run cells (killing any still running at the time
    limit), print each and gate: no error, the state's local bytes those
    of the specs."""
    deadline = time.perf_counter() + DRYRUN_TIMEOUT_S
    cells, failed = [], []
    for (arch, shape, multi_pod), proc, out in procs:
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        tag = f"{arch} x {shape} x {'2x16x16' if multi_pod else '16x16'}"
        if rc != 0 or not out.exists():
            tail = out.with_suffix(".log").read_text()[-1500:]
            print(f"phase 15 (c) dry-run {tag}: exit {rc}\n{tail}")
            failed.append(tag)
            continue
        (r,) = json.loads(out.read_text())
        b = r["bytes_per_device"]
        coll = {k: r["collectives"]["bytes"][k]
                for k in sorted(r["collectives"]["bytes"])}
        print(f"phase 15 (c) dry-run {tag} ({smi}; traced on the host in "
              f"{r['trace_s']} s, policy {r['policy']}): per device peak "
              f"{b['peak_est'] / 2 ** 30:.2f} GiB (state "
              f"{b['state'] / 2 ** 30:.2f}, inputs "
              f"{b['inputs'] / 2 ** 30:.2f}, activations "
              f"{b['activation_peak'] / 2 ** 30:.2f}), "
              f"{r['flops_per_device']:.4e} FLOPs, "
              f"{r['op_bytes_per_device']:.4e} op bytes (unfused), "
              f"collective bytes {coll}; t_compute "
              f"{r['t_compute'] * 1e3:.3f} ms, t_memory "
              f"{r['t_memory'] * 1e3:.3f} ms, t_collective "
              f"{r['t_collective'] * 1e3:.3f} ms (989e12 FLOP/s, 3.35e12 "
              f"B/s, link {r['link_bw']:.3g} B/s) -> {r['bottleneck']}, "
              f"roofline fraction {r['roofline_fraction']:.4%}, model "
              f"flops ratio {r['model_flops_ratio']:.4f}")
        if b["state"] != b["state_from_specs"]:
            print(f"phase 15 (c) {tag}: state {b['state']} bytes, the "
                  f"specs give {b['state_from_specs']}")
            failed.append(tag)
        cells.append(r)
    if failed:
        raise AssertionError(f"phase 15 (c): dry-run cells failed: {failed}")
    return cells


def serve_sharded(torch, np) -> dict:
    """Phase 15 (a): Yi-9B unsharded, then on the (1, 1) mesh of an NCCL
    world of one; the same prompt, prefill and greedy tokens."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.sharding.context import activation_sharding, \
        shard_batch

    cfg = configs.get("yi_9b")
    model = api.init(cfg, seed=SEED, device="cuda", dtype=torch.bfloat16)
    b, s0, n_new = SERVE_BATCH, SERVE_PROMPT, SHARD_NEW
    max_s = s0 + n_new
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s0))).cuda()

    def run(tokens):
        api.prefill(model, cfg, {"tokens": tokens}, init())   # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        logits, caches, prefill_ms, flash_ms, n_flash = timed_prefill(
            torch, api, model, cfg, tokens, init())
        launches = ops.launch_counts()["flash_attention"]
        dec, generated, _, ms = greedy_decode(torch, api, model, cfg, logits,
                                              caches, n_new)
        return dec, generated, prefill_ms, ms, launches, n_flash

    init = lambda: api.init_caches(model, cfg, b, max_s)    # noqa: E731
    dec_u, gen_u, prefill_u, ms_u, flash_u, _ = run(prompt)

    torch.distributed.init_process_group(
        "nccl", store=torch.distributed.HashStore(), rank=0, world_size=1)
    mesh = make_host_mesh(model=1)
    specs.shard_model(model, cfg, mesh)
    sharded_calls = []
    entry = flash_mod.flash_attention_sharded

    def counted(*args, **kw):
        sharded_calls.append(1)
        return entry(*args, **kw)

    flash_mod.flash_attention_sharded = counted
    try:
        with activation_sharding(mesh):
            init = lambda: specs.shard_caches(                # noqa: E731
                cfg, api.init_caches(model, cfg, b, max_s), mesh)
            sharded_calls.clear()
            dec_s, gen_s, prefill_s, ms_s, flash_s, n_flash = run(
                shard_batch(prompt))
    finally:
        flash_mod.flash_attention_sharded = entry
    dec_s, gen_s = dec_s.full_tensor(), gen_s.full_tensor()
    err = float((dec_s.float() - dec_u.float()).abs().max())
    same = bool(torch.equal(gen_s, gen_u))
    # the warm-up prefill took the sharded entry once a layer too
    sharded = len(sharded_calls) - cfg.n_layers
    print(f"phase 15 (a) yi-9b on mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
          f"(NCCL world of 1): prefill {b}x{s0} {prefill_s:.1f} ms sharded "
          f"vs {prefill_u:.1f} ms unsharded; flash launches {flash_s} "
          f"({sharded} through the sharded entry, on local shards; "
          f"unsharded {flash_u}); decode {n_new} tokens {ms_s:.2f} vs "
          f"{ms_u:.2f} ms/token (DTensor's host cost); tokens identical: "
          f"{same}; decode logits max|d| {err:.4f} (tol {DECODE_LOGIT_TOL})")
    if flash_s != cfg.n_layers or sharded != cfg.n_layers or \
            n_flash != cfg.n_layers:
        raise AssertionError("phase 15 (a): the sharded prefill did not "
                             "launch flash once a layer on local shards")
    if not same or not err <= DECODE_LOGIT_TOL or \
            not bool(torch.isfinite(dec_s).all()):
        raise AssertionError("phase 15 (a): sharded decode differs")
    return {"mesh": mesh, "prefill_ms": prefill_s,
            "prefill_ms_unsharded": prefill_u, "decode_ms": ms_s,
            "decode_ms_unsharded": ms_u, "flash_launches": flash_s,
            "max_abs_logit_diff": err}


def train_sharded(torch, np, mesh, phase14: dict) -> dict:
    """Phase 15 (b): Mamba2-370M, 4 AdamW steps on ``mesh`` through
    ``train_loop.train``, against phase 14 (b)'s first four; its last
    save read back bit for bit."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.checkpoint import store
    from repro_torch.train.train_step import checkpoint_tree

    cfg = dataclasses.replace(configs.get("mamba2_370m"), remat=MAMBA_REMAT)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-sharded-") as d:
        state, rows = _train(torch, cfg, MAMBA_TRAIN_BATCH,
                             SHARD_TRAIN_STEPS, "(b) mamba2 sharded",
                             phase=15, mesh=mesh, ckpt_dir=d,
                             save_every=SHARD_TRAIN_STEPS)
        manifest = json.loads((Path(d) / f"step_{SHARD_TRAIN_STEPS}" /
                               "manifest.json").read_text())
        tree = checkpoint_tree(state)
        back = store.restore(d, SHARD_TRAIN_STEPS, tree, mesh=mesh)
        same = all(
            _bits_equal(torch, a.full_tensor(), b.full_tensor())
            for (_, a), (_, b) in zip(store.leaf_paths(tree),
                                      store.leaf_paths(back))
            if isinstance(a, torch.Tensor))
    specs = [e["spec"] for e in manifest["leaves"] if "spec" in e]
    ref = phase14["mamba2"]["rows"][:SHARD_TRAIN_STEPS]
    gaps = [abs(r["loss"] - q["loss"]) / abs(q["loss"])
            for r, q in zip(rows, ref)]
    walls = sorted(r["wall_ms"] for r in rows[1:])
    ref_walls = sorted(r["wall_ms"] for r in phase14["mamba2"]["rows"][1:])
    print(f"phase 15 (b) mamba2 sharded: losses "
          f"{[round(r['loss'], 4) for r in rows]} vs phase 14 "
          f"{[round(q['loss'], 4) for q in ref]} (largest relative gap "
          f"{max(gaps):.3e}, limit {SHARDED_LOSS_RTOL:.3e}); median step "
          f"{walls[len(walls) // 2]:.1f} ms vs phase 14's "
          f"{ref_walls[len(ref_walls) // 2]:.1f} ms; checkpoint mesh_shape "
          f"{manifest['mesh_shape']}, {sum(1 for x in specs if x is not None)}"
          f" of {len(specs)} leaves with a spec, read back bit for bit: "
          f"{same}")
    if max(gaps) > SHARDED_LOSS_RTOL or not same or \
            manifest["mesh_shape"] != {"data": 1, "model": 1} or \
            not any(x is not None for x in specs):
        raise AssertionError("phase 15 (b): sharded training differs")
    return {"rows": rows, "gaps": gaps, "median_step_ms":
            walls[len(walls) // 2]}


def distribution_phase(torch, np, phase14: dict, smi: str) -> dict:
    """Phase 15: (a) and (b) on the card's mesh of one, (c) on the host."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    try:
        out = {"serve": serve_sharded(torch, np)}
        launches = dict(ops.launch_counts())
        release(torch)
        out["train"] = train_sharded(torch, np, out["serve"]["mesh"],
                                     phase14)
        if ops.launch_counts() != launches:
            raise AssertionError("phase 15 (b) launched a hand kernel")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        release(torch)
    # (a) and (b) are host-bound: the dry-run's processes start after them
    t1 = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="chip-smoke-dryrun-"))
    out["dryrun"] = finish_dryrun(start_dryrun(out_dir), smi)
    print(f"phase 15 (c) took {time.perf_counter() - t1:.1f}s; phase 15 "
          f"took {time.perf_counter() - t0:.1f}s")
    return out


#: Phase 16: the batch of the kernel checks, the points of the batched
#: path (one of the ``small`` grid's, and the Experiment 1 points), the
#: batches each is timed at, and the timed replays per measurement.
BATCHED_KERNEL_BATCH = 8
BATCHED_POINTS = (
    ("aatb", (96, 64, 128), (1, 32, 256)),
    ("abcd", (96, 64, 128, 32, 96), (1, 32, 256)),
    ("abab", (96, 64, 128), (1, 32, 256)),
    ("aatb", (1200, 800, 400), (32,)),
    ("abcd", (400, 1200, 400, 1200, 400), (32,)),
    ("abab", (1200, 800, 400), (32,)))
BATCHED_REPS = 10


def batched_kernel_cases(torch, rng, batch: int):
    """(kernel, label, kernel call, plain call, library call, flops,
    bytes) of one instance, on ``batch`` instances: at phase 3's main-path
    shape and at a ragged shape with transposed views. The library call is
    one batched ATen call (``torch.bmm``) or expression."""
    from repro_torch.kernels import ops, ref

    def mats(r, c, view=False):
        x = rng.standard_normal((batch, c, r) if view else (batch, r, c))
        t = torch.from_numpy(x).float().to(DEVICE)
        return t.mT if view else t

    def sym_with_garbage(m):
        s = mats(m, m)
        return torch.tril(s + s.mT) + torch.triu(mats(m, m) * 1e3, 1)

    def full(s):
        return torch.tril(s) + torch.tril(s, -1).mT

    f = 4
    cases = []
    for label, (m, k, n), view in (("1200x400x1200", (1200, 400, 1200), False),
                                   ("1100x333x1037, A=Xᵀ views",
                                    (1100, 333, 1037), True)):
        A, B = mats(m, k, view), mats(k, n)
        cases.append(("gemm", label, lambda A=A, B=B: ops.gemm(A, B),
                      lambda A=A, B=B: ref.gemm(A, B),
                      lambda A=A, B=B: torch.bmm(A, B),
                      2 * m * n * k, f * (m * k + k * n + m * n)))
    for label, (m, k), view in (("1200x800", (1200, 800), False),
                                ("1100x333, A=Xᵀ views", (1100, 333), True)):
        A = mats(m, k, view)
        cases.append(("syrk", label, lambda A=A: ops.syrk(A),
                      lambda A=A: ref.syrk(A),
                      lambda A=A: torch.tril(torch.bmm(A, A.mT)),
                      (m + 1) * m * k, f * (m * k + m * m)))
    for label, (m, n), side_r in (
            ("1200x400, garbage above diag", (1200, 400), False),
            ("1100x333 side R, B=Yᵀ views, garbage above diag", (1100, 333),
             True)):
        S = sym_with_garbage(m)
        if side_r:
            Y = mats(n, m)
            run = lambda S=S, Y=Y: ops.symm(S, Y.mT).mT
            plain = lambda S=S, Y=Y: Y @ ref.tri2full(S)
            library = lambda S=S, Y=Y: torch.bmm(Y, full(S))
        else:
            B = mats(m, n)
            run = lambda S=S, B=B: ops.symm(S, B)
            plain = lambda S=S, B=B: ref.symm(S, B)
            library = lambda S=S, B=B: torch.bmm(full(S), B)
        cases.append(("symm", label, run, plain, library, 2 * m * m * n,
                      f * (m * (m + 1) // 2 + 2 * m * n)))
    for label, (m, k, l, n), view in (
            ("1200*800*1200*400", (1200, 800, 1200, 400), False),
            ("1100*333*1037*555, C=Zᵀ views", (1100, 333, 1037, 555), True)):
        A, B, C = mats(m, k), mats(k, l), mats(l, n, view)
        cases.append(("chain_gemm", label,
                      lambda A=A, B=B, C=C: ops.chain_gemm(A, B, C),
                      lambda A=A, B=B, C=C: ref.chain_gemm(A, B, C),
                      lambda A=A, B=B, C=C: torch.bmm(torch.bmm(A, B), C),
                      2 * m * k * l + 2 * m * l * n,
                      f * (m * k + k * l + l * n + m * n)))
    for label, (m, k, l), view in (
            ("1200·400·800", (1200, 400, 800), False),
            ("1100·333·1037, A=Xᵀ views", (1100, 333, 1037), True)):
        A, B = mats(m, k, view), mats(k, l)

        def library(A=A, B=B):
            m1 = torch.bmm(A, B)
            return torch.tril(torch.bmm(m1, m1.mT))

        cases.append(("gemm_syrk", label,
                      lambda A=A, B=B: ops.gemm_syrk(A, B),
                      lambda A=A, B=B: ref.gemm_syrk(A, B), library,
                      2 * m * l * k + (m + 1) * m * l,
                      f * (m * k + k * l + m * m)))
    return cases


def check_batched_kernels(torch, np) -> dict:
    """Phase 16 (a): each of the five matrix kernels on a batch of
    :data:`BATCHED_KERNEL_BATCH` instances in one launch, each instance
    against its plain version at phase 3's tolerance, timed per launch
    and per instance beside one batched ATen call and the bound of the
    batch's work."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(SEED)
    batch = BATCHED_KERNEL_BATCH
    results = {}
    for name, label, run, plain, library, flops, nbytes in \
            batched_kernel_cases(torch, rng, batch):
        before = ops.launch_counts()[name]
        out = run()
        launched = ops.launch_counts()[name] - before
        expect = plain()
        torch.cuda.synchronize()
        if launched != 1:
            raise AssertionError(f"batched {name} [{label}]: {launched} "
                                 f"launches for one batch, not 1")
        if out.shape != expect.shape or out.shape[0] != batch or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"batched {name} [{label}]: bad output "
                                 f"{tuple(out.shape)} vs "
                                 f"{tuple(expect.shape)}")
        rtol, atol = TOL[name]
        diff = (out - expect).abs()
        max_abs = float(diff.max())
        if name == "gemm_syrk":   # per instance, as phase 3 holds one
            scale = expect.abs().amax(dim=(1, 2))
            ok = bool((diff.amax(dim=(1, 2)) <= atol + rtol * scale).all())
        else:
            ok = bool((diff <= atol + rtol * expect.abs()).all())
        if name in ("syrk", "gemm_syrk") and \
                bool((torch.triu(out, 1) != 0).any()):
            raise AssertionError(f"batched {name} [{label}]: nonzero "
                                 f"entries above the diagonal")
        ms, plain_ms, lib_ms = (time_ms(torch, run), time_ms(torch, plain),
                                time_ms(torch, library))
        ms_b2b = time_ms(torch, run, inner=10)
        lib_b2b = time_ms(torch, library, inner=10)
        b_ms, b_by = bound(batch * flops, batch * nbytes)
        print(f"phase 16 batched {name:10s} [{label}] x{batch}: "
              f"max_abs_err={max_abs:.3e} {'ok' if ok else 'FAIL'}; "
              f"ms={ms:.4f} ({ms / batch:.4f} an instance) "
              f"ms_b2b={ms_b2b:.4f} ({ms_b2b / batch:.4f} an instance) "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"(b2b {lib_b2b:.4f}) bound_ms={b_ms:.4f} ({b_by}) "
              f"TFLOP/s={batch * flops / ms_b2b / 1e9:.2f} (b2b) "
              f"bound_share={b_ms / ms_b2b:.1%} (b2b) "
              f"b2b kernel/library={ms_b2b / lib_b2b:.3f}")
        if not ok:
            raise AssertionError(f"batched {name} [{label}] disagrees with "
                                 f"its plain version beyond tolerance")
        r = results.setdefault(name, {"batch": batch, "max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], max_abs)
        if "ms" not in r:   # the first case is phase 3's main-path shape
            r.update(shape=label, ms=ms, ms_b2b=ms_b2b,
                     ms_per_instance=ms / batch,
                     ms_b2b_per_instance=ms_b2b / batch, plain_ms=plain_ms,
                     library_ms=lib_ms, library_ms_b2b=lib_b2b,
                     bound_ms=b_ms, bound_by=b_by)
    return results


def batched_path(torch) -> dict:
    """Phase 16 (b): every algorithm of aatb, abcd and abab on the
    ``cuda`` backend's batched path, at :data:`BATCHED_POINTS`:
    ``execute_batch`` per instance against ``execute`` (phase 5's
    tolerance), and ``time_algorithm_batched`` (one replayed graph of the
    batched walk) per instance against ``time_algorithm`` at each batch,
    with the launches of one batched replay gated to equal the
    algorithm's kernel steps. Launches counted from 0 over the path."""
    from repro_torch.core.backends import get_backend, register_torch_backends
    from repro_torch.core.expressions import get_spec
    from repro_torch.kernels import ops

    register_torch_backends()
    rows = []
    ops.reset_launch_counts()
    for family, point, batches in BATCHED_POINTS:
        # A backend a point, so that its graphs' pools go with it.
        runner = get_backend("cuda", reps=BATCHED_REPS, seed=SEED)
        if runner.timing != "graph":
            raise AssertionError("the cuda backend does not time CUDA graphs")
        for alg in get_spec(family).algorithms(point):
            operands = runner.make_operands(alg)
            before = ops.launch_counts()
            runner.execute(alg, operands)
            after = ops.launch_counts()
            steps = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
            single_ms = runner.time_algorithm(alg, operands) * 1e3
            row = {"family": family, "point": list(point),
                   "algorithm": alg.name, "steps": steps,
                   "time_algorithm_ms": single_ms, "batched": {}}
            for batch in batches:
                batched = runner.make_batched_operands(alg, batch)
                if batch == max(batches):   # per instance vs execute
                    got = runner.execute_batch(alg, batched)
                    for i in range(batch):
                        want = runner.execute(
                            alg, {b: t[i] for b, t in batched.items()})
                        _agree(torch, f"{family}{point} {alg.name} batch "
                               f"{batch} instance {i}", got[i], want,
                               quiet=True)
                # A graph memo miss: the eager walk, a warm-up replay and
                # the timed replays each launch every step once.
                before = ops.launch_counts()
                ms = runner.time_algorithm_batched(alg, operands=batched) * 1e3
                after = ops.launch_counts()
                counts = {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}
                executions = 2 + BATCHED_REPS
                if counts != {k: n * executions for k, n in steps.items()}:
                    raise AssertionError(
                        f"{family}{point} {alg.name} batch {batch}: "
                        f"{counts} launches in {executions} executions, not "
                        f"the algorithm's steps {steps} each")
                row["batched"][batch] = {
                    "ms": ms, "ms_per_instance": ms / batch,
                    "per_instance_over_single": ms / batch / single_ms,
                    "launches_per_replay": {k: n // executions
                                            for k, n in counts.items()}}
                del batched
            print(f"phase 16 {family}{point} {alg.name}: time_algorithm "
                  f"{single_ms:.4f} ms; batched per instance " + ", ".join(
                      f"b{b} {r['ms_per_instance']:.4f} ms "
                      f"({r['per_instance_over_single']:.3f}x)"
                      for b, r in row["batched"].items()) +
                  f"; launches a replay {steps}")
            rows.append(row)
        del runner
        release(torch)
    total = ops.launch_counts()
    print(f"phase 16 kernel launches: {total}")
    idle = [k for k in SWEEP_STEPS if not total[k]]
    if idle:
        raise AssertionError(f"phase 16 never launched {idle}")
    return {"rows": rows, "launches": total}


def batched_phase(torch, np) -> dict:
    """Phase 16: the batched path, kernels (a) then algorithms (b)."""
    t0 = time.perf_counter()
    kernels = check_batched_kernels(torch, np)
    path = batched_path(torch)
    ratios = [r["per_instance_over_single"] for row in path["rows"]
              for r in row["batched"].values()]
    for family, point, batches in BATCHED_POINTS:
        for b in batches:
            rs = sorted(row["batched"][b]["per_instance_over_single"]
                        for row in path["rows"]
                        if row["family"] == family
                        and row["point"] == list(point))
            print(f"phase 16 {family}{point} batch {b}: per-instance time "
                  f"over time_algorithm, median {rs[len(rs) // 2]:.4f} "
                  f"(min {rs[0]:.4f}, max {rs[-1]:.4f}) over {len(rs)} "
                  f"algorithms")
    print(f"phase 16: {len(path['rows'])} algorithm points, "
          f"{len(ratios)} batched timings, {time.perf_counter() - t0:.1f} s")
    return {"kernels": kernels, **path}


def memory_line(torch, phase: int) -> None:
    """The card's peak reserved memory since the start, after a phase."""
    print(f"device memory after phase {phase}: peak reserved "
          f"{torch.cuda.max_memory_reserved() / 2 ** 30:.2f} GiB, now "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB")


def release(torch) -> None:
    """Hand the memory of the last phase's backends and graphs back to the
    card (a released graph's pool is freed only by ``empty_cache``)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


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
    memory_line(torch, 3)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-atlas-") as d:
        launches, by_family = run_sweeps(torch, Path(d))
        release(torch)
        memory_line(torch, 4)
        check_algorithms(torch)
        memory_line(torch, 5)
        results["flash_attention"] = check_flash(torch, np)
        memory_line(torch, 6)
        served = serve_model(torch, np)
        launches["flash_attention"] = served["launches"]["flash_attention"]
        release(torch)
        memory_line(torch, 7)
        predicted = calibrate_predict_evaluate(Path(d))
        release(torch)
        memory_line(torch, 8)
        sweep_engine(torch, Path(d), by_family)
        release(torch)
        phase10 = tuning_and_planner(torch, np, Path(d), by_family)
    memory_line(torch, 10)
    families = serve_families(torch, np)
    launches["flash_attention"] += \
        families["olmoe"]["launches"]["flash_attention"]
    release(torch)
    memory_line(torch, 11)
    phase12 = paper_protocol(torch, np, by_family)
    release(torch)
    memory_line(torch, 12)
    phase13 = serve_encdec_vlm(torch, np)
    launches["flash_attention"] += \
        phase13["internvl2"]["launches"]["flash_attention"]
    release(torch)
    memory_line(torch, 13)
    phase14 = train_phase(torch, np)
    memory_line(torch, 14)
    phase15 = distribution_phase(torch, np, phase14, smi)
    launches["flash_attention"] += phase15["serve"]["flash_launches"]
    memory_line(torch, 15)
    release(torch)
    phase16 = batched_phase(torch, np)
    memory_line(torch, 16)

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
            "launches_phase8": predicted["launches"].get(name, 0),
            "launches_phase10": phase10["launches"].get(name, 0),
            "launches_phase10_by_part": {
                part: counts.get(name, 0)
                for part, counts in phase10["parts"].items()},
            "launches_phase10_tune": phase10["tune_launches"].get(name, 0),
            "launches_phase12": phase12.get(name, 0),
            "launches_phase16": phase16["launches"].get(name, 0)})
        if name in phase16["kernels"]:
            kernels[-1]["batched"] = phase16["kernels"][name]
    flash = families["flash"]
    next(k for k in kernels if k["name"] == "flash_attention")["phase11"] = {
        "shape": flash["shape"], "max_abs_err": flash["max_abs_err"],
        "ms": flash["ms"], "ms_b2b": flash["ms_b2b"],
        "plain_ms": flash["plain_ms"], "library_ms": flash["library_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "launches_olmoe_prefill":
            families["olmoe"]["launches"]["flash_attention"],
        "launches_shape_check": flash["check_launches"]}
    flash = phase13["flash"]
    next(k for k in kernels if k["name"] == "flash_attention")["phase13"] = {
        "shape": flash["shape"], "max_abs_err": flash["max_abs_err"],
        "ms": flash["ms"], "ms_b2b": flash["ms_b2b"],
        "plain_ms": flash["plain_ms"], "library_ms": flash["library_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "launches_internvl2_prefill":
            phase13["internvl2"]["flash_launches_per_prefill"],
        "launches_internvl2": phase13["internvl2"]["launches"][
            "flash_attention"],
        "launches_shape_check": flash["check_launches"]}
    next(k for k in kernels if k["name"] == "flash_attention")["phase15"] = {
        "launches_yi9b_sharded_prefill": phase15["serve"]["flash_launches"],
        "sharded_prefill_ms": phase15["serve"]["prefill_ms"],
        "unsharded_prefill_ms": phase15["serve"]["prefill_ms_unsharded"]}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
