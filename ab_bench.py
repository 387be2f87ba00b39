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
* ``symm``: every (m, n, side) the sweep launches ({400, 800, 1200}², S·B
  and B·S) by both methods under the launch the tree picks, beside the
  port's ``ops.gemm`` on the same (m, m, n) product, and on a tree with
  ``symm_config`` every other tile and split, back to back;
* ``chain``: every (m, k, l, n) the sweep launches (59 of
  {400, 800, 1200}⁴) by both methods under the launch the tree picks,
  beside the port's two ``ops.gemm`` calls it fuses, and on a tree with
  ``chain_config`` every piece, by both methods;
* ``syrk``: every (m, k) the sweep launches SYRK at by both methods under
  the launch the tree picks, beside the port's ``ops.gemm(A, A.mT)`` (the
  GEMM of the whole square on the same operands), and on a tree with
  ``syrk_config`` every tile and split, back to back;
* ``gemm_syrk``: every (m, k, l) the sweep launches the fused pair at by
  both methods under the launch the tree picks, beside the port's
  unfused ``ops.syrk(ops.gemm(A, B))``, and on a tree with
  ``gemm_syrk_config`` every chunk width and cluster size, back to back;
* ``flash``: the bf16 kernel at one Yi-9B prefill layer beside SDPA;
* ``algorithms``: every algorithm of ``aatb`` at every point of
  {400, 800, 1200}³ on the ``cuda`` backend (``chip_smoke.time_algorithms``):
  its eager time, its ``time_algorithm`` time (one replayed CUDA graph on
  a tree that times graphs) and the sum of its steps' ``ms_b2b``, with the
  host share as the ratio of each algorithm time to that sum.

``--sections`` names the sections to time (all by default)::

    python3 ab_bench.py --src src --label change --sections syrk gemm_syrk

``--symm-variant`` times instead the design ``csrc/symm.cu`` replaced,
rebuilt from the tree's sources with :data:`RUNTIME_MODE_PATCH`, beside
the tree's SYMM under every launch at the sweep's (m, n), back to back
(``symm_variant`` lines), and prints the variant's ptxas report.

``--fit FILE`` reads such lines back (no card needed) and, for
each label, prints how often the chosen launch of gemm, symm, the chain,
syrk and gemm_syrk is within 10 % of the fastest one timed back to back
(and, for syrk and gemm_syrk, how far the pick lies from the fastest at
each shape), how many of the sweep's chain launches fall on shapes
where the chain runs above
1.15× the two GEMMs it fuses, and the variant's time against the
tree's::

    python3 ab_bench.py --src src --fit ab.jsonl
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import subprocess
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
#: Sections of a timing run, in the order they run.
SECTIONS = ("case", "gemm", "symm", "chain", "syrk", "gemm_syrk", "flash",
            "algorithms")
#: The chain's ``ms_b2b`` over its two GEMMs' above which a sweep shape
#: counts as slow (the acceptance bound at the main-path shape).
CHAIN_SLOW = 1.15
#: The SYMM design before its band got a call site of its own: every
#: segment copied through ``SlabCopier<BW, true>``, which then tests the
#: operand's mode at run time. Source file -> (text, variant text) pairs.
RUNTIME_MODE_PATCH = {
    "symm.cu": ((
        "    if (seg == 1)   // the band: its own call site, its copier "
        "fixed at kSymLower\n"
        "      accumulate<BM, BN, true>(a, b, row0, col0, lo, hi, smem, acc);\n"
        "    else\n"
        "      accumulate<BM, BN>(a, b, row0, col0, lo, hi, smem, acc);\n",
        "    accumulate<BM, BN, true>(a, b, row0, col0, lo, hi, smem, acc);\n"),),
    "sgemm.cuh": (("    if (SYM) {", "    if (SYM && mode == kSymLower) {"),),
}


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


def sweep_shapes() -> dict:
    """Kernel -> {shape: Counter(family -> steps)} of the sweep of
    ``chip_smoke.py``, found by walking every algorithm of its grids
    through the ``cuda`` backend's kernel vocabulary on meta tensors
    (nothing is computed): ``gemm`` as (m, k, n), ``symm`` as (m, n,
    side), ``chain_gemm`` as (m, k, l, n), ``syrk`` as (m, k) and
    ``gemm_syrk`` as (m, k, l). The sweep launches each step
    ``chip_smoke.EXECUTIONS`` times. Shapes iterate in sorted order."""
    import torch
    from repro_torch.core.algorithms import Leaf
    from repro_torch.core.backends.base import walk_steps
    from repro_torch.core.backends.torch_backend import CudaOps
    from repro_torch.core.expressions import get_spec

    seen = {kind: collections.defaultdict(collections.Counter)
            for kind in ("gemm", "symm", "chain_gemm", "syrk", "gemm_syrk")}
    family = ""

    class Shapes(CudaOps):
        def gemm(self, a, b):
            seen["gemm"][a.shape[0], a.shape[1], b.shape[1]][family] += 1
            return a @ b

        def syrk(self, a):
            seen["syrk"][a.shape[0], a.shape[1]][family] += 1
            return a @ a.mT

        def symm(self, s, b):
            seen["symm"][b.shape[0], b.shape[1], "L"][family] += 1
            return s @ b

        def symm_r(self, b, s):
            seen["symm"][b.shape[1], b.shape[0], "R"][family] += 1
            return b @ s

        def tri2full(self, t):
            return t

        def chain_gemm(self, a, b, c):
            seen["chain_gemm"][a.shape[0], a.shape[1], b.shape[1],
                               c.shape[1]][family] += 1
            return a @ b @ c

        def gemm_syrk(self, a, b):
            seen["gemm_syrk"][a.shape[0], a.shape[1], b.shape[1]][family] += 1
            return (a @ b) @ (a @ b).mT

    ops = Shapes()
    for family, axis in chip_smoke.SWEEPS:
        spec = get_spec(family)
        for point in itertools.product(axis, repeat=spec.ndims):
            for alg in spec.algorithms(point):
                leaves = {r.base: (r.cols, r.rows) if r.transposed
                          else (r.rows, r.cols)
                          for step in alg.steps for r in (step.lhs, step.rhs)
                          if isinstance(r, Leaf)}
                walk_steps(alg.steps, lambda base: torch.empty(
                    leaves[base], device="meta"), ops)
    return {kind: dict(sorted(shapes.items()))
            for kind, shapes in seen.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="directory holding the repro_torch package")
    ap.add_argument("--label")
    ap.add_argument("--fit", metavar="FILE",
                    help="report on the lines of an earlier run instead")
    ap.add_argument("--symm-variant", action="store_true",
                    help="time the tree's SYMM beside RUNTIME_MODE_PATCH's")
    ap.add_argument("--sections", nargs="+", choices=SECTIONS,
                    default=list(SECTIONS), help="the sections to time")
    args = ap.parse_args()
    # The named tree's package, not the one beside chip_smoke.py.
    sys.path.insert(0, str(Path(args.src).resolve()))
    if args.fit:
        fit_report(Path(args.fit))
        return 0
    if not args.label:
        ap.error("--label is required to time")
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ab_bench: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    label = args.label
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = sweep_shapes()
    if args.symm_variant:
        time_symm_variant(torch, np, label, shapes["symm"])
        return 0

    sections = set(args.sections)
    if "case" in sections:
        for name, shape, run, plain, *_ in chip_smoke.kernel_cases(
                torch, np.random.default_rng(chip_smoke.SEED)):
            print(json.dumps({"case": name, "shape": shape, "label": label,
                              "kernel": both(torch, run),
                              "plain": both(torch, plain)}))
    if "gemm" in sections:
        time_gemm(torch, np, label, sms)
    if "symm" in sections:
        time_symm(torch, np, label, shapes["symm"], sms)
    if "chain" in sections:
        time_chain(torch, np, label, shapes["chain_gemm"], sms)
    if "syrk" in sections:
        time_syrk(torch, np, label, shapes["syrk"], sms)
    if "gemm_syrk" in sections:
        time_gemm_syrk(torch, np, label, shapes["gemm_syrk"])
    if "flash" in sections:
        rng = np.random.default_rng(chip_smoke.SEED)
        bsz, h, hkv, s, d = 2, 32, 4, 2048, 128
        q, k, v = (chip_smoke.attention_heads(torch, rng, bsz, s, n, d,
                                              torch.bfloat16, scale)
                   for n, scale in ((h, chip_smoke.QK_SCALE),
                                    (hkv, chip_smoke.QK_SCALE), (hkv, 1.0)))
        print(json.dumps({
            "flash": f"B{bsz} H{h}/{hkv} S{s} D{d} bf16 causal",
            "label": label,
            **both(torch, lambda: ops.flash_attention(q, k, v)),
            "library": both(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))}))
    if "algorithms" in sections:
        for point in itertools.product(SWEEP_DIMS, repeat=3):
            for row in chip_smoke.time_algorithms(torch, "aatb", point,
                                                  label=f"[{label}] "):
                print(json.dumps({"algorithms": "aatb", "label": label,
                                  **row}))
    return 0


def time_gemm(torch, np, label: str, sms: int) -> None:
    """One line per (m, k, n) in SWEEP_DIMS³: ops.gemm by both methods,
    its host time, and every tile and split the tree can launch."""
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels import ops

    rng = np.random.default_rng(chip_smoke.SEED)
    tuned = hasattr(gemm_mod, "gemm_config")
    for m, k, n in itertools.product(SWEEP_DIMS, repeat=3):
        a = torch.from_numpy(rng.standard_normal((m, k))).float().cuda()
        b = torch.from_numpy(rng.standard_normal((k, n))).float().cuda()
        line = {"gemm": f"{m}x{k}x{n}", "label": label,
                "config": (gemm_mod.gemm_config(m, n, k, sms).name if tuned
                           else "64x64"),
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


def time_symm(torch, np, label: str, shapes, sms: int) -> None:
    """One line per (m, n, side): ops.symm by both methods, ops.gemm on
    the same (m, m, n) product, and every launch the tree can make."""
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import symm as symm_mod

    tuned = hasattr(symm_mod, "symm_config")
    rng = np.random.default_rng(chip_smoke.SEED)
    for m, n, side in shapes:
        s = rng.standard_normal((m, m))
        s = torch.from_numpy(np.tril(s) + np.triu(s * 1e3, 1)).float().cuda()
        if side == "L":
            b = torch.from_numpy(rng.standard_normal((m, n))).float().cuda()
        else:   # B·S = (S·Bᵀ)ᵀ with Bᵀ a view
            b = torch.from_numpy(rng.standard_normal((n, m))).float().cuda().mT
        full = torch.tril(s) + torch.tril(s, -1).mT
        line = {"symm": f"{m}x{n}", "side": side, "label": label,
                "config": (symm_mod.symm_config(m, n, sms).name if tuned
                           else "64x64"),
                **both(torch, lambda: ops.symm(s, b)),
                "gemm": both(torch, lambda: ops.gemm(full, b))}
        if tuned:
            line["configs_b2b"] = {
                cfg.name: chip_smoke.time_ms(
                    torch, lambda cfg=cfg: symm_mod.launch(s, b, cfg),
                    inner=10)
                for cfg in gemm_mod.candidates(m)}
        print(json.dumps(line))


def time_chain(torch, np, label: str, shapes, sms: int) -> None:
    """One line per (m, k, l, n): ops.chain_gemm by both methods, the two
    ops.gemm calls it fuses, and every piece the tree can launch."""
    from repro_torch.kernels import chain_gemm as chain_mod
    from repro_torch.kernels import ops

    tuned = hasattr(chain_mod, "chain_config")
    rng = np.random.default_rng(chip_smoke.SEED)
    for m, k, l, n in shapes:
        a, b, c = (torch.from_numpy(rng.standard_normal(shape)).float().cuda()
                   for shape in ((m, k), (k, l), (l, n)))
        line = {"chain": f"{m}*{k}*{l}*{n}", "label": label,
                "config": (chain_mod.chain_config(m, k, l, n, sms).name
                           if tuned else "64x64"),
                **both(torch, lambda: ops.chain_gemm(a, b, c)),
                "two_gemms": both(torch, lambda: ops.gemm(ops.gemm(a, b), c))}
        if tuned:
            line["configs"] = {
                cfg.name: both(torch, lambda cfg=cfg: chain_mod.launch(
                    a, b, c, cfg))
                for cfg in chain_mod.CONFIGS}
        print(json.dumps(line))


def time_syrk(torch, np, label: str, shapes, sms: int) -> None:
    """One line per (m, k): ops.syrk by both methods, ops.gemm(A, A.mT)
    on the same operands, and every tile and split the tree can launch."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import syrk as syrk_mod

    tuned = hasattr(syrk_mod, "syrk_config")
    rng = np.random.default_rng(chip_smoke.SEED)
    for m, k in shapes:
        a = torch.from_numpy(rng.standard_normal((m, k))).float().cuda()
        line = {"syrk": f"{m}x{k}", "label": label,
                "config": (syrk_mod.syrk_config(m, k, sms).name if tuned
                           else "64x64"),
                **both(torch, lambda: ops.syrk(a)),
                "gemm": both(torch, lambda: ops.gemm(a, a.mT))}
        if tuned:
            line["configs_b2b"] = {
                cfg.name: chip_smoke.time_ms(
                    torch, lambda cfg=cfg: syrk_mod.launch(a, cfg), inner=10)
                for cfg in syrk_mod.syrk_candidates(k)}
        print(json.dumps(line))


def time_gemm_syrk(torch, np, label: str, shapes) -> None:
    """One line per (m, k, l): ops.gemm_syrk by both methods, the port's
    unfused ops.syrk(ops.gemm(A, B)), and every launch the tree can make."""
    from repro_torch.kernels import gemm_syrk as fused_mod
    from repro_torch.kernels import ops

    tuned = hasattr(fused_mod, "gemm_syrk_config")
    active = fused_mod.active_clusters(0) if tuned else None
    rng = np.random.default_rng(chip_smoke.SEED)
    for m, k, l in shapes:
        a = torch.from_numpy(rng.standard_normal((m, k))).float().cuda()
        b = torch.from_numpy(rng.standard_normal((k, l))).float().cuda()
        line = {"gemm_syrk": f"{m}*{k}*{l}", "label": label,
                "config": (fused_mod.gemm_syrk_config(m, k, l, active).name
                           if tuned else "64x64"),
                **both(torch, lambda: ops.gemm_syrk(a, b)),
                "unfused": both(torch, lambda: ops.syrk(ops.gemm(a, b)))}
        if tuned:
            line["configs_b2b"] = {
                cfg.name: chip_smoke.time_ms(
                    torch, lambda cfg=cfg: fused_mod.launch(a, b, cfg),
                    inner=10)
                for cfg in fused_mod.candidates(m)}
        print(json.dumps(line))


def _pick_distance(lines, key: str) -> str:
    """The chosen launch over the fastest timed, at each shape (worst
    first), from ``configs_b2b``."""
    ratios = sorted(((x["configs_b2b"][x["config"]]
                      / min(x["configs_b2b"].values()), x[key]) for x in lines),
                    reverse=True)
    return "; pick/fastest " + ", ".join(f"{shape} {r:.3f}"
                                          for r, shape in ratios)


def _within(lines, timings, chosen) -> str:
    """How often the chosen launch is within 10 % of the fastest timed,
    and the summed times of the chosen and of the fastest launches."""
    picks = [(timings(line)[chosen(line)], min(timings(line).values()))
             for line in lines]
    near = sum(t <= 1.1 * best for t, best in picks)
    return (f"within 10 % at {near}/{len(picks)}; chosen sum "
            f"{sum(t for t, _ in picks) * 1e3:.1f} us, fastest sum "
            f"{sum(b for _, b in picks) * 1e3:.1f} us")


def fit_report(path: Path) -> None:
    """The launch rules against the back-to-back timings of every launch
    in a file of this script's lines, by label."""
    lines = [json.loads(t) for t in path.read_text().splitlines()
             if t.startswith("{")]
    for label in sorted({line["label"] for line in lines}):
        mine = [line for line in lines if line["label"] == label]
        gemms = [x for x in mine if isinstance(x.get("gemm"), str)
                 and "configs_b2b" in x]
        symms = [x for x in mine if "symm" in x and "configs_b2b" in x]
        chains = [x for x in mine if "chain" in x and "configs" in x]
        syrks = [x for x in mine if "syrk" in x and "configs_b2b" in x]
        fused = [x for x in mine if "gemm_syrk" in x and "configs_b2b" in x]
        algos = [x for x in mine if "algorithms" in x]
        print(f"[{label}]")
        if algos:
            import statistics
            print(f"algorithms: {len(algos)}, median eager/b2b "
                  f"{statistics.median(x['eager_over_b2b'] for x in algos):.3f}"
                  f", {algos[0]['timing']}/b2b "
                  f"{statistics.median(x['timed_over_b2b'] for x in algos):.3f}")
        if gemms:
            print("gemm: " + _within(gemms, lambda x: x["configs_b2b"],
                                     lambda x: x["config"]))
        if symms:
            print("symm: " + _within(symms, lambda x: x["configs_b2b"],
                                     lambda x: x["config"]))
        if chains:
            b2b = lambda x: {k: v["ms_b2b"] for k, v in x["configs"].items()}
            print("chain: " + _within(chains, b2b, lambda x: x["config"]))
        if any("chain" in x for x in mine):
            chain_slow_report([x for x in mine if "chain" in x])
        if syrks:
            print("syrk: " + _within(syrks, lambda x: x["configs_b2b"],
                                     lambda x: x["config"])
                  + _pick_distance(syrks, "syrk"))
        if fused:
            print("gemm_syrk: " + _within(fused, lambda x: x["configs_b2b"],
                                          lambda x: x["config"])
                  + _pick_distance(fused, "gemm_syrk"))
        variants = [x for x in mine if "symm_variant" in x]
        if variants:
            symm_variant_report(variants)


def chain_slow_report(chains) -> None:
    """The sweep's chain launches on shapes where the chain runs above
    CHAIN_SLOW times its two GEMMs by ``ms_b2b`` (each summed over the
    label's runs), by family."""
    times = collections.defaultdict(lambda: [0.0, 0.0])
    for x in chains:
        shape = tuple(map(int, x["chain"].split("*")))
        times[shape][0] += x["ms_b2b"]
        times[shape][1] += x["two_gemms"]["ms_b2b"]
    runs = len(chains) / len(times)
    slow, total = collections.Counter(), collections.Counter()
    excess = 0.0   # ms over the two GEMMs, summed over the slow launches
    for shape, steps in sweep_shapes()["chain_gemm"].items():
        chain, two = times[shape]
        for family, n in steps.items():
            total[family] += n * (1 + chip_smoke.REPS)
            if chain > CHAIN_SLOW * two:
                slow[family] += n * (1 + chip_smoke.REPS)
                excess += n * (1 + chip_smoke.REPS) * (chain - two) / runs
    n_slow = sum(chain > CHAIN_SLOW * two for chain, two in times.values())
    by_family = ", ".join(f"{f} {slow[f]}/{total[f]}" for f in sorted(total))
    print(f"chain: above {CHAIN_SLOW}x the two GEMMs at {n_slow}/"
          f"{len(times)} shapes, {sum(slow.values())}/"
          f"{sum(total.values())} sweep launches ({by_family}), "
          f"{excess:.1f} ms over the two GEMMs on those launches")


def symm_variant_report(lines) -> None:
    """The run-time-mode variant against the tree's SYMM, back to back."""
    by_cfg = collections.defaultdict(lambda: [0.0, 0.0])
    for x in lines:
        by_cfg[x["config"].split(" split")[0]][0] += x["tree_b2b"]
        by_cfg[x["config"].split(" split")[0]][1] += x["variant_b2b"]
    worst = max(lines, key=lambda x: x["variant_b2b"] / x["tree_b2b"])
    tree = sum(t for t, _ in by_cfg.values())
    variant = sum(v for _, v in by_cfg.values())
    print(f"symm variant: {sum(x['variant_b2b'] > x['tree_b2b'] for x in lines)}"
          f"/{len(lines)} launches slower; summed {tree * 1e3:.1f} us (tree) "
          f"against {variant * 1e3:.1f} us (variant), "
          + ", ".join(f"{tile} {t * 1e3:.1f} / {v * 1e3:.1f}"
                      for tile, (t, v) in sorted(by_cfg.items()))
          + f"; worst {worst['symm_variant']} {worst['config']} "
          f"{worst['variant_b2b'] / worst['tree_b2b']:.3f}x; outputs "
          f"bitwise equal at {sum(x['equal'] for x in lines)}/{len(lines)}")
    chosen = [x for x in lines if x["chosen"]]
    print(f"symm variant at the launches symm_config picks: "
          f"{sum(x['variant_b2b'] > x['tree_b2b'] for x in chosen)}/"
          f"{len(chosen)} slower; summed "
          f"{sum(x['tree_b2b'] for x in chosen) * 1e3:.1f} us (tree) against "
          f"{sum(x['variant_b2b'] for x in chosen) * 1e3:.1f} us (variant)")


def time_symm_variant(torch, np, label: str, shapes) -> None:
    """Build RUNTIME_MODE_PATCH's SYMM from the tree's sources (its ptxas
    report printed) and time it beside the tree's SYMM under every launch
    at each (m, n) of the sweep, side L, back to back, in the order tree,
    variant, variant, tree; one ``symm_variant`` line per launch."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels import symm as symm_mod

    out = _build.BUILD_DIR / "symm-runtime-mode"
    out.mkdir(parents=True, exist_ok=True)
    for name, edits in RUNTIME_MODE_PATCH.items():
        text = (_build.CSRC / name).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name} no longer holds the text that "
                                   f"RUNTIME_MODE_PATCH replaces: {old!r}")
            text = text.replace(old, new)
        (out / name).write_text(text)
    lib = out / "libsymm_variant.so"
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(out),
         str(out / "symm.cu"), "-o", str(lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (out / "symm.log").write_text("== symm.cu (variant)\n" + proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the variant:\n{proc.stdout}")
    chip_smoke.print_ptxas_report(out / "symm.log")
    variant = ctypes.CDLL(str(lib)).repro_symm_f32
    variant.argtypes = _build.SIGNATURES["repro_symm_f32"]
    variant.restype = ctypes.c_int

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(chip_smoke.SEED)
    for m, n in sorted({(m, n) for m, n, _ in shapes}):
        s = rng.standard_normal((m, m))
        s = torch.from_numpy(np.tril(s) + np.triu(s * 1e3, 1)).float().cuda()
        b = torch.from_numpy(rng.standard_normal((m, n))).float().cuda()
        chosen = symm_mod.symm_config(m, n, sms)
        for cfg in gemm_mod.candidates(m):
            def run_variant(cfg=cfg):   # as symm.launch makes its call
                c = torch.empty((m, n), device="cuda")
                ws = (torch.empty((cfg.split, m, n), device="cuda")
                      if cfg.split > 1 else None)
                _build.check(variant(
                    s.data_ptr(), s.stride(0), s.stride(1),
                    b.data_ptr(), b.stride(0), b.stride(1), c.data_ptr(),
                    None if ws is None else ws.data_ptr(), m, n, cfg.config,
                    cfg.split, cfg.kchunk, _build.stream(0)), "symm variant")
                return c
            tree = lambda cfg=cfg: symm_mod.launch(s, b, cfg)
            times = [chip_smoke.time_ms(torch, fn, inner=10)
                     for fn in (tree, run_variant, run_variant, tree)]
            print(json.dumps({
                "symm_variant": f"{m}x{n}", "config": cfg.name,
                "chosen": cfg == chosen, "label": label,
                "tree_b2b": (times[0] + times[3]) / 2,
                "variant_b2b": (times[1] + times[2]) / 2,
                "equal": bool(torch.equal(run_variant(), tree()))}))

if __name__ == "__main__":
    sys.exit(main())
