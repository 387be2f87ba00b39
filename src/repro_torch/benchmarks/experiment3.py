"""Paper Experiment 3 (§3.4.3): predict anomalies from isolated kernel
benchmarks (the additive model) — the confusion matrix against measured
ground truth.

Ground truth comes from Experiments 1 and 2 (fanned out with
``REPRO_SWEEP_SHARDS``, persisted in the anomaly atlas); the isolated
kernel benchmarks are deduplicated, seeded from the calibration cache of
the measuring backend's fingerprint and saved back to it, so only calls
never timed before are timed.

The paper reports ABCD recall 92 % / precision 96 % and AAᵀB recall
75 % / precision 98.5 %, on MKL. The claim under test: most anomalies
are predictable from per-kernel profiles alone.

    PYTHONPATH=src python -m repro_torch.benchmarks.experiment3
"""

from __future__ import annotations

import time

from repro_torch.core.experiments import (experiment1_random_search,
                                          experiment2_regions,
                                          experiment3_predict_from_benchmarks)
from repro_torch.core.expressions import get_spec
from repro_torch.core.profile_store import load_default_profile, save_profile

from .common import (DEVICE, FULL, emit, engine_kwargs, make_runner, note,
                     open_atlas)


def run_spec(spec, box, n_seeds, reps, max_samples, step=10):
    runner = make_runner(reps)  # the serial probes use it
    kwargs = engine_kwargs(reps)
    t0 = time.perf_counter()
    with open_atlas(spec.name, 0.10) as seed_atlas:
        seeds = experiment1_random_search(
            spec, None if kwargs else runner, box=box, n_anomalies=n_seeds,
            max_samples=max_samples, threshold=0.10, seed=11,
            atlas=seed_atlas, **kwargs)
    if not seeds.anomalies:
        note(f"Experiment 3 {spec.name}: no anomaly seeds in budget")
        emit(f"exp3_{spec.name}_recall", 0.0, "no_anomalies")
        return None
    t1 = time.perf_counter()
    with open_atlas(spec.name, 0.05) as atlas:
        regions = experiment2_regions(spec, runner, seeds.anomalies,
                                      box=box, step=step, threshold=0.05,
                                      atlas=atlas)
    t2 = time.perf_counter()
    # Seed from this backend's calibration (only calls it lacks are
    # timed), then save the enriched table back under the same
    # fingerprint, so one backend's timings never enter another's.
    backend, dtype = runner.fingerprint_tags()
    cached = load_default_profile(backend=backend, dtype=dtype,
                                  device=DEVICE)
    res = experiment3_predict_from_benchmarks(
        spec, runner, regions.classified, threshold=0.05, profile=cached)
    save_profile(res.profile, runner.fingerprint(),
                 meta={"source": f"experiment3:{spec.name}"})
    t3 = time.perf_counter()
    note(f"\n== Experiment 3: {spec.name} ==")
    note(f"(kernel calls: {res.n_calls_reused} reused from the "
         f"calibration cache, {res.n_calls_measured} newly measured)")
    note(f"wall: seeds {t1 - t0:.1f}s ({seeds.samples} samples), regions "
         f"{t2 - t1:.1f}s ({len(regions.classified)} points), kernel "
         f"benchmarks {t3 - t2:.1f}s")
    note(res.confusion.as_table())
    emit(f"exp3_{spec.name}_recall", res.confusion.recall * 100,
         f"precision={res.confusion.precision:.3f};"
         f"n={res.confusion.total}")
    return res


def main(scale=None):
    """aatb (and abcd at paper scale) at ``scale`` (``(box, seeds, reps,
    seed-search samples, step)``; default: the configured scale)."""
    if scale is None:
        scale = (((20, 1200), 25, 10, 2500, 10) if FULL
                 else ((20, 600), 4, 3, 250, 10))
    box, n_seeds, reps, max_samples, step = scale
    run_spec(get_spec("aatb"), box, n_seeds, reps, max_samples, step)
    if FULL:
        run_spec(get_spec("abcd"), box, 10, reps, max_samples, step)


if __name__ == "__main__":
    main()
