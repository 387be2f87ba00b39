"""Quickstart of the PyTorch port: the planner in 60 seconds.

The counterpart of ``examples/quickstart.py``: builds the paper's two
expressions, enumerates their algorithms, shows the FLOP counts, selects
with both discriminants, executes the plan on the ``cuda`` backend (the
hand-written kernels; their plain versions with ``--device cpu``),
measures a real instance with BLAS to look for an anomaly, and evaluates
one algorithm over a batch of operand sets in one dispatch a step.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.algorithms import enumerate_algorithms
from repro_torch.core.backends import get_backend, register_torch_backends
from repro_torch.core.expr import gram_times, matrix_chain
from repro_torch.core.expressions import GRAM_AATB, registered_names
from repro_torch.core.perfmodel import AnalyticalHopperProfile
from repro_torch.core.planner import Planner
from repro_torch.core.runners import BlasRunner
from repro_torch.core.selector import select_expression
from repro_torch.core.sweep import measure_instance


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    register_torch_backends()

    # --- 1. the paper's matrix chain ABCD -----------------------------
    chain = matrix_chain(331, 279, 338, 854, 427)   # a paper anomaly seed
    algos = enumerate_algorithms(chain)
    print(f"ABCD instance (331,279,338,854,427): {len(algos)} algorithms")
    for a in sorted(algos, key=lambda a: a.flops):
        print(f"  {a.name:24s} {a.flops/1e6:10.1f} MFLOPs")

    # --- 2. the paper's AAᵀB expression --------------------------------
    g = gram_times(300, 700, 200)
    for a in enumerate_algorithms(g):
        print(f"  {a.name:28s} {a.flops/1e6:10.1f} MFLOPs  "
              f"[{' → '.join(c.kind for c in a.calls)}]")

    # --- 3. plan + execute via the runtime planner ---------------------
    p_flops = Planner(discriminant="flops", device=args.device).plan(g)
    p_model = Planner(discriminant="perfmodel", device=args.device).plan(g)
    print(f"flops discriminant chose:     {p_flops.algorithm.name}")
    print(f"perfmodel discriminant chose: {p_model.algorithm.name}")

    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal((300, 700))).float().to(
        args.device)
    B = torch.from_numpy(rng.standard_normal((300, 200))).float().to(
        args.device)
    out = p_model.fn(A, A, B)
    ref = A @ A.T @ B
    print(f"plan output max err vs direct: "
          f"{float((out - ref).abs().max()):.2e}")

    # --- 4. measure one real instance with BLAS (the paper's method) ---
    runner = BlasRunner(reps=3)
    inst = measure_instance(GRAM_AATB, (128, 512, 96), runner,
                            threshold=0.10)
    print(f"measured instance {inst.point}: "
          f"anomaly={inst.cls.is_anomaly} "
          f"time_score={inst.cls.time_score:.1%} "
          f"flop_score={inst.cls.flop_score:.1%}")
    print(f"  cheapest: {inst.cls.cheapest}")
    print(f"  fastest:  {inst.cls.fastest}")

    # --- 5. the expression zoo ----------------------------------------
    # Every registered family selects/sweeps through the same machinery;
    # (AB)(AB)ᵀ enumerates the intermediate-Gram GEMM+SYRK algorithm
    # that leaf-level inspection cannot see.
    print(f"registered families: {', '.join(registered_names())}")
    ranked = select_expression("abab", (256, 64, 512),
                               discriminant="perfmodel",
                               profile=AnalyticalHopperProfile())
    print(f"abab(256,64,512) perfmodel pick: {ranked[0].name} "
          f"({ranked[0].flops/1e6:.1f} MFLOPs of "
          f"{len(ranked)} candidates)")

    # --- 6. the batched path: many instances, one launch a step -------
    cuda = get_backend("cuda", reps=3, seed=0, device=args.device)
    alg = ranked[0]
    operands = cuda.make_batched_operands(alg, 32)
    out = cuda.execute_batch(alg, operands)
    per_instance = cuda.time_algorithm_batched(alg, operands=operands) / 32
    single = cuda.time_algorithm(alg)
    print(f"abab {alg.name} over a batch of 32: output "
          f"{tuple(out.shape)}, {per_instance * 1e6:.1f} µs an instance "
          f"against {single * 1e6:.1f} µs for one ({cuda.timing} timing "
          f"on {args.device})")


if __name__ == "__main__":
    main()
