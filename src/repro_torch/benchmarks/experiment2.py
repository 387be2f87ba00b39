"""Paper Experiment 2 (§3.4.2): axis-aligned lines through anomalous
regions — the distribution of region thickness per dimension.

Seeds come from a short Experiment 1 search (fanned out with
``REPRO_SWEEP_SHARDS``); each is traversed in every dimension at step
10, hole tolerance 2, boundary at 3 consecutive non-anomalies (the
paper's protocol, threshold 5 %). Seeds and every probe persist in the
anomaly atlas, so a re-run traverses cached classifications.

    PYTHONPATH=src python -m repro_torch.benchmarks.experiment2
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.experiments import (experiment1_random_search,
                                          experiment2_regions)
from repro_torch.core.expressions import get_spec

from .common import FULL, emit, engine_kwargs, make_runner, note, open_atlas


def run_spec(spec, box, n_seeds, reps, max_samples, step=10):
    runner = make_runner(reps)  # the serial probes use it
    kwargs = engine_kwargs(reps)
    with open_atlas(spec.name, 0.10) as seed_atlas:
        seeds = experiment1_random_search(
            spec, None if kwargs else runner, box=box, n_anomalies=n_seeds,
            max_samples=max_samples, threshold=0.10, seed=7,
            atlas=seed_atlas, **kwargs)
    if not seeds.anomalies:
        note(f"Experiment 2 {spec.name}: no anomalies found in budget; "
             "skipping region scan")
        emit(f"exp2_{spec.name}_thickness", 0.0, "no_anomalies")
        return None
    with open_atlas(spec.name, 0.05) as atlas:
        res = experiment2_regions(spec, runner, seeds.anomalies, box=box,
                                  step=step, threshold=0.05, atlas=atlas)
    note(f"\n== Experiment 2: {spec.name} "
         f"({len(seeds.anomalies)} seeds) ==")
    by_dim = {}
    for scan in res.scans:
        by_dim.setdefault(scan.dim, []).append(scan.thickness)
    for dim, ths in sorted(by_dim.items()):
        note(f"d{dim}: thickness median={np.median(ths):.0f} "
             f"max={max(ths)} min={min(ths)} (n={len(ths)})")
        emit(f"exp2_{spec.name}_d{dim}_thickness", float(np.median(ths)),
             f"max={max(ths)};min={min(ths)};n={len(ths)}")
    return res


def main(scale=None):
    """aatb (and abcd at paper scale) at ``scale`` (``(box, seeds, reps,
    seed-search samples, step)``; default: the configured scale)."""
    if scale is None:
        scale = (((20, 1200), 30, 10, 2500, 10) if FULL
                 else ((20, 600), 5, 3, 250, 10))
    box, n_seeds, reps, max_samples, step = scale
    run_spec(get_spec("aatb"), box, n_seeds, reps, max_samples, step)
    if FULL:
        run_spec(get_spec("abcd"), box, 10, reps, max_samples, step)


if __name__ == "__main__":
    main()
