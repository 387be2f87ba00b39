"""Paper Experiment 1 (§3.4.1): random search for anomalies — abundance
and severity, for both expressions.

Sampling and measurement go through :func:`repro_torch.core.sweep.sweep`
(fanned out with ``REPRO_SWEEP_SHARDS``), and every classified instance
streams into the persistent anomaly atlas, so a repeat run resumes.

Paper scale (``REPRO_BENCH_SCALE=full``): box [20, 1200], 100 / 1000
anomalies, at most 25,000 / 12,000 samples. CI scale: box [20, 600],
8 / 25 anomalies, at most 300 samples each.

    PYTHONPATH=src python -m repro_torch.benchmarks.experiment1
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.experiments import experiment1_random_search
from repro_torch.core.expressions import get_spec

from .common import FULL, emit, engine_kwargs, make_runner, note, open_atlas


def run_spec(spec, box, n_anom, max_samples, reps, threshold=0.10,
             seed=0):
    # A sharded run builds its workers' runners from engine_kwargs; the
    # serial runner (and its flush buffer) exists only when used.
    kwargs = engine_kwargs(reps)
    runner = None if kwargs else make_runner(reps)
    with open_atlas(spec.name, threshold) as atlas:
        n_cached = len(atlas)
        res = experiment1_random_search(
            spec, runner, box=box, n_anomalies=n_anom,
            max_samples=max_samples, threshold=threshold, seed=seed,
            atlas=atlas, **kwargs)
    ts = [i.cls.time_score for i in res.anomalies]
    fs = [i.cls.flop_score for i in res.anomalies]
    note(f"\n== Experiment 1: {spec.name} ==")
    note(f"samples={res.samples} anomalies={len(res.anomalies)} "
         f"abundance={res.abundance:.2%} wall={res.wall_s:.1f}s "
         f"(atlas held {n_cached} instances going in)")
    if ts:
        note(f"time_score:  max={max(ts):.1%} median={np.median(ts):.1%}")
        note(f"flop_score:  max={max(fs):.1%} median={np.median(fs):.1%}")
        sev = sum(1 for t, f in zip(ts, fs) if t > 0.20 or f > 0.30)
        note(f"severe (ts>20% or fs>30%): {sev}/{len(ts)}")
    emit(f"exp1_{spec.name}_abundance",
         res.wall_s * 1e6 / max(res.samples, 1),
         f"abundance={res.abundance:.4f};n={len(res.anomalies)};"
         f"samples={res.samples}")
    return res


def main(scale=None):
    """Both expressions at ``scale`` (``(box, abcd anomalies, abcd
    samples, aatb anomalies, aatb samples, reps)``; default: the
    configured CI or paper scale)."""
    if scale is None:
        scale = (((20, 1200), 100, 25000, 1000, 12000, 10) if FULL
                 else ((20, 600), 8, 300, 25, 300, 3))
    box, n_abcd, max_abcd, n_aatb, max_aatb, reps = scale
    run_spec(get_spec("abcd"), box, n_abcd, max_abcd, reps=reps)
    run_spec(get_spec("aatb"), box, n_aatb, max_aatb, reps=reps)


if __name__ == "__main__":
    main()
