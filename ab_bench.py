#!/usr/bin/env python3
"""Time the port's kernels from one source tree on the card, for A/B runs.

Run from the repository root, naming the tree whose ``repro_torch`` to
time (an older one unpacked with ``git archive`` included)::

    python3 ab_bench.py --src src --label change
    python3 ab_bench.py --src /path/to/parent/src --label parent

It times through the public entry points (``ops.*``) with
``chip_smoke.time_ms`` and on ``chip_smoke``'s own inputs, so one
definition of kernel time serves both scripts. Two cards, or one card at
two times, differ by more than the changes measured here: alternate the
trees within one session on one card (parent, change, change, parent).

Each measurement is one JSON line holding the tree's ``label``:

* ``case``: every kernel case of ``chip_smoke.kernel_cases`` — kernel and
  plain version, each timed one call per event pair (``ms``, as
  ``chip_smoke.py`` reports it) and ten calls back to back (``ms_b2b``);
* ``gemm``: every (m, k, n) in {400, 800, 1200}³, which holds every GEMM
  the anomaly sweep launches, under the launch the tree picks, and on a
  tree with ``gemm_config`` every other tile and contraction split,
  back to back; and the wrapper's host time per call;
* ``flash``: the bf16 kernel at one Yi-9B prefill layer beside SDPA.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import chip_smoke

#: Dims of the GEMMs the sweep launches (every axis value of aatb, abab
#: and abcd's grids).
SWEEP_DIMS = (400, 800, 1200)
#: Contraction splits timed beside the chosen launch (the wrapper picks
#: from 1 to ``gemm.MAX_SPLIT``).
SPLITS = (1, 2, 3, 4, 6, 8)
#: Calls whose host time is averaged.
HOST_CALLS = 200


def both(torch, fn) -> dict:
    """One call per event pair, and ten back to back."""
    return {"ms": chip_smoke.time_ms(torch, fn),
            "ms_b2b": chip_smoke.time_ms(torch, fn, inner=10)}


def host_us(torch, fn) -> float:
    """Host microseconds per call, the card left to catch up after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / HOST_CALLS * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="directory holding the repro_torch package")
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    # The named tree's package, not the one beside chip_smoke.py.
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ab_bench: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    label = args.label

    for name, shape, run, plain, *_ in chip_smoke.kernel_cases(
            torch, np.random.default_rng(chip_smoke.SEED)):
        print(json.dumps({"case": name, "shape": shape, "label": label,
                          "kernel": both(torch, run),
                          "plain": both(torch, plain)}))

    rng = np.random.default_rng(chip_smoke.SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tuned = hasattr(gemm_mod, "gemm_config")
    for m, k, n in itertools.product(SWEEP_DIMS, repeat=3):
        a = torch.from_numpy(rng.standard_normal((m, k))).float().cuda()
        b = torch.from_numpy(rng.standard_normal((k, n))).float().cuda()
        line = {"gemm": f"{m}x{k}x{n}", "label": label,
                "config": (gemm_mod.gemm_config(m, n, k, sms).name if tuned
                           else "64x64 (tile.cuh)"),
                **both(torch, lambda: ops.gemm(a, b)),
                "host_us": host_us(torch, lambda: ops.gemm(a, b))}
        if tuned:
            configs = {gemm_mod.with_split(c, k, s)
                       for c in range(len(gemm_mod.TILES)) for s in SPLITS}
            line["configs_b2b"] = {
                cfg.name: chip_smoke.time_ms(
                    torch, lambda cfg=cfg: gemm_mod.launch(a, b, cfg),
                    inner=10)
                for cfg in sorted(configs, key=lambda c: (c.config, c.split))}
        print(json.dumps(line))

    bsz, h, hkv, s, d = 2, 32, 4, 2048, 128
    q, k, v = (chip_smoke.attention_heads(torch, rng, bsz, s, n, d,
                                          torch.bfloat16, scale)
               for n, scale in ((h, chip_smoke.QK_SCALE),
                                (hkv, chip_smoke.QK_SCALE), (hkv, 1.0)))
    print(json.dumps({
        "flash": f"B{bsz} H{h}/{hkv} S{s} D{d} bf16 causal", "label": label,
        **both(torch, lambda: ops.flash_attention(q, k, v)),
        "library": both(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
