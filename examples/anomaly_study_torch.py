"""Mini reproduction of the paper end to end on the PyTorch port:
Experiments 1→2→3 on AAᵀB.

The counterpart of ``examples/anomaly_study.py``, on the ``cuda``
backend (the hand-written kernels, each algorithm timed as one replayed
CUDA graph; their plain versions, timed eagerly, with ``--device cpu``):
random-searches for anomalies, traverses one region, then predicts
anomalies from isolated kernel benchmarks and prints the confusion
matrix — the complete §3.4 pipeline, scaled to a few minutes.

Everything measured here persists: classified instances stream into the
anomaly atlas (see ``python -m repro_torch.core.sweep``) and kernel
timings are reused from — and persisted back to — the calibrated profile
cache (``python -m repro_torch.core.calibrate``), so repeat runs resume
from disk instead of re-measuring. ``--max-samples`` and ``--box-hi``
shrink the search (the smallest setting takes seconds on the CPU).

Run:  PYTHONPATH=src python examples/anomaly_study_torch.py [--device cpu]
"""

import argparse

from repro_torch.core.backends import get_backend, register_torch_backends
from repro_torch.core.experiments import (
    experiment1_random_search,
    experiment2_regions,
    experiment3_predict_from_benchmarks,
)
from repro_torch.core.expressions import GRAM_AATB
from repro_torch.core.profile_store import load_default_profile, save_profile
from repro_torch.core.sweep import AnomalyAtlas


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-samples", type=int, default=150)
    ap.add_argument("--box-hi", type=int, default=500)
    args = ap.parse_args()
    register_torch_backends()
    runner = get_backend("cuda", reps=3, device=args.device)
    fp = runner.fingerprint()
    box = (20, args.box_hi)

    print(f"Experiment 1: random search for anomalies (box [20, "
          f"{args.box_hi}]³) on {fp.device}...")
    with AnomalyAtlas.open(GRAM_AATB.name, fp, threshold=0.10) as atlas:
        if len(atlas):
            print(f"  (atlas resumes from {len(atlas)} instances at "
                  f"{atlas.path})")
        e1 = experiment1_random_search(
            GRAM_AATB, runner, box=box, n_anomalies=6,
            max_samples=args.max_samples, threshold=0.10, seed=2,
            verbose=True, atlas=atlas, device=args.device)
    print(f"  abundance ≈ {e1.abundance:.1%} "
          f"({len(e1.anomalies)}/{e1.samples} samples)")
    if not e1.anomalies:
        print("  no anomalies in this tiny budget — rerun with a larger "
              "--max-samples")
        return

    print("\nExperiment 2: region traversal around the first anomaly...")
    with AnomalyAtlas.open(GRAM_AATB.name, fp, threshold=0.05) as atlas2:
        e2 = experiment2_regions(GRAM_AATB, runner, e1.anomalies[:2],
                                 box=box, threshold=0.05, atlas=atlas2,
                                 device=args.device)
    for scan in e2.scans[:6]:
        print(f"  seed={scan.origin} dim=d{scan.dim}: region "
              f"[{scan.lo}, {scan.hi}] thickness={scan.thickness}")

    print("\nExperiment 3: predict anomalies from kernel benchmarks...")
    cached = load_default_profile(device=args.device)
    n_cached = len(cached.table) if cached is not None else 0
    if n_cached:
        print(f"  (seeding from {n_cached} persisted kernel timings)")
    e3 = experiment3_predict_from_benchmarks(
        GRAM_AATB, runner, e2.classified, threshold=0.05, profile=cached,
        device=args.device)
    path = save_profile(e3.profile, fp,
                        meta={"source": "examples/anomaly_study_torch"})
    print(f"  (kernel calls: {e3.n_calls_reused} reused, "
          f"{e3.n_calls_measured} newly measured; profile now "
          f"{len(e3.profile.table)} entries -> {path})")
    print(e3.confusion.as_table())
    print("\npaper's qualitative claim — anomalies are largely "
          "predictable from per-kernel profiles — "
          f"{'CONFIRMED' if e3.confusion.recall > 0.5 else 'NOT confirmed'}"
          f" here (recall {e3.confusion.recall:.0%}).")
    print("\nNext: map whole regions with the sharded grid sweep —\n"
          "  PYTHONPATH=src python -m repro_torch.core.sweep --expr aatb "
          "--grid small --shards 4")


if __name__ == "__main__":
    main()
