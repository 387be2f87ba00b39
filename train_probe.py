"""Zamba2-1.2B's first AdamW steps on the card, under variants.

Phase 14 (e) of ``chip_smoke.py`` trains Zamba2-1.2B at full width and
depth from random weights (1 × 2048 tokens a step, 4 steps, warm-up 2)
and gates on the loss falling; its losses swing in those steps. This
script repeats that run's steps through ``train_step`` and varies one
thing at a time, to tell a fault of the port from the optimizer's own
early dynamics:

* the peak lr (1e-5 … 1e-3) and the seed of the weights and data;
* ``compute_dtype`` float32 in place of bf16 (with ``remat="full"``,
  which the float32 activations need to fit; a bf16 run with it shows
  what remat alone changes);
* the dense attention route in place of the chunked core in the shared
  block;
* a line search: where a step's loss rose, the loss on that step's
  batch along the previous update, θ + α·Δ for α in ``ALPHAS``. A loss
  that first falls and then rises along Δ is an update too long for the
  curvature; one that rises from α = 0 is a wrong gradient.

Then chunked attention's phase 14 (a) check and the training ``gpu``
tests, whose dk/dv limits read the excess printed here. Run from the
repo root on a machine with one card::

    python3 train_probe.py
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

STEPS, WARMUP, SEQ, DEVICE = 4, 2, 2048, "cuda"
ALPHAS = (0.0, 0.125, 0.25, 0.5, 0.75, 1.0)
#: (label, peak lr, seed, compute dtype, remat, dense attention).
RUNS = ([("bf16", lr, 0, "bfloat16", "none", False)
         for lr in (1e-5, 3e-5, 1e-4, 3e-4, 1e-3)]
        + [("bf16 remat full", 1e-4, 0, "bfloat16", "full", False)]
        + [("float32 remat full", lr, 0, "float32", "full", False)
           for lr in (1e-4, 3e-4, 1e-3)]
        + [("bf16 dense attention", lr, 0, "bfloat16", "none", True)
           for lr in (1e-4, 3e-4, 1e-3)]
        + [("bf16", lr, seed, "bfloat16", "none", False)
           for seed in (1, 2) for lr in (3e-5, 1e-4, 3e-4, 1e-3)])


def _loss_at(torch, ts, api, state, cfg, batch, dtype) -> float:
    """The loss of ``batch`` at the masters, through a working copy in
    ``dtype`` as the train step makes it."""
    from repro_torch.optim.leaves import reference_ndim

    names = list(state.params)
    owners = ts._owners(state.model, names)
    work = [torch.nn.Parameter(p.to(dtype) if reference_ndim(n, p) >= 2
                               else p, requires_grad=False)
            for n, p in state.params.items()]
    ts._install(owners, work)
    try:
        with torch.no_grad():
            return float(api.loss_fn(state.model, cfg, batch)[1]["loss"])
    finally:
        ts._install(owners, [state.params[n] for n in names])


def run(torch, label, lr, seed, dtype_name, remat, dense) -> list:
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import api, attention
    from repro_torch.train import train_step as ts

    cfg = dataclasses.replace(configs.get("zamba2_1p2b"), remat=remat)
    dtype = getattr(torch, dtype_name)
    source = SyntheticLM(cfg.vocab, SEQ, 1, seed=seed)
    state = ts.make_train_state(cfg, seed=seed, device=DEVICE)
    real = attention.chunked_attention
    if dense:
        attention.chunked_attention = \
            lambda acfg, q, k, v, block=512: attention._dense_attention(
                acfg, q, k, v)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rows, before = [], None
    try:
        for step in range(STEPS):
            batch = {k: torch.from_numpy(v).to(DEVICE)
                     for k, v in source.batch_at(step).items()}
            if rows and rows[-1][2] > 0 and rows[-1][0] < _loss_at(
                    torch, ts, api, state, cfg, batch, dtype):
                after = {n: p.clone() for n, p in state.params.items()}
                losses = []
                for a in ALPHAS:
                    for n, p in state.params.items():
                        p.copy_(before[n] + a * (after[n] - before[n]))
                    losses.append(_loss_at(torch, ts, api, state, cfg,
                                           batch, dtype))
                for n, p in state.params.items():
                    p.copy_(after[n])
                del after
                print(f"  {label} lr {lr:g} seed {seed}: the loss rose at "
                      f"step {step}; along the last update (alpha "
                      f"{', '.join(f'{a:g}' for a in ALPHAS)}): "
                      f"{', '.join(f'{x:.4f}' for x in losses)}", flush=True)
            before = {n: p.clone() for n, p in state.params.items()}
            t0 = time.perf_counter()
            state, m = ts.train_step(state, batch, cfg=cfg, peak_lr=lr,
                                     warmup=WARMUP, total_steps=STEPS,
                                     compute_dtype=dtype)
            m = {k: float(v) for k, v in m.items()}
            rows.append((m["loss"], m["grad_norm"], m["lr"],
                         (time.perf_counter() - t0) * 1e3))
    finally:
        attention.chunked_attention = real
    peak = torch.cuda.max_memory_reserved() / 1e9 if DEVICE == "cuda" \
        else float("nan")
    print(f"{label} lr {lr:g} seed {seed}: losses "
          f"{', '.join(f'{r[0]:.4f}' for r in rows)}; grad norms "
          f"{', '.join(f'{r[1]:.2f}' for r in rows)}; step ms "
          f"{', '.join(f'{r[3]:.0f}' for r in rows)}; peak reserved "
          f"{peak:.2f} GB", flush=True)
    return rows


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("train_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke

    print(f"card: {chip_smoke.nvidia_smi_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    for spec in RUNS:
        run(torch, *spec)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"runs: {time.perf_counter() - t0:.1f}s", flush=True)
    try:
        chip_smoke.check_chunked(torch, np)
    except AssertionError as e:
        print(f"phase 14 (a): {e}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-s", "-p", "no:cacheprovider",
         "-m", "gpu", "tests/test_torch_gpu.py", "-k",
         "chunked_core or train_step"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH="src"),
        capture_output=True, text=True, timeout=600)
    print(tests.stdout[-6000:], tests.stderr[-2000:])
    return tests.returncode


if __name__ == "__main__":
    sys.exit(main())
