"""Shared plumbing of the experiment drivers: configuration from the
environment, the engine, the atlas and the CSV rows.

The port's copy of the reference's ``benchmarks/common.py``. Every
driver prints ``name,us_per_call,derived`` rows on standard output, the
measuring backend's fingerprint in ``derived``, and readable tables on
standard error. The environment configures them:

* ``REPRO_BENCH_SCALE`` — ``ci`` (default: boxes to 600 and a few hundred
  samples) or ``full`` (the paper's box to 1200 and thousands of samples);
* ``REPRO_EXEC_BACKEND`` — the registry backend measured on: ``cuda``
  (default, the hand-written kernels on the card), ``torch``, or the
  reference's default ``blas`` (float64 on the host; ``numpy`` too);
* ``REPRO_SWEEP_SHARDS`` — worker processes for a host backend, or cards
  for a device backend (1, the default, measures in this process);
* ``REPRO_DEVICE`` — where a device backend runs: ``cuda`` (default) or
  ``cpu``; a host backend ignores it.
"""

from __future__ import annotations

import functools
import os
import sys

FULL = os.environ.get("REPRO_BENCH_SCALE", "ci") == "full"
SHARDS = max(1, int(os.environ.get("REPRO_SWEEP_SHARDS", "1")))
EXEC_BACKEND = os.environ.get("REPRO_EXEC_BACKEND", "cuda")
DEVICE = os.environ.get("REPRO_DEVICE", "cuda")


def _registry():
    """The backend registry, with the port's backends registered."""
    from repro_torch.core import backends
    backends.register_torch_backends()
    return backends


def make_runner(reps: int, **opts):
    """The configured backend, built as the CLIs build it."""
    return _registry().make_backend(EXEC_BACKEND, reps=reps, device=DEVICE,
                                    **opts)


def engine_kwargs(reps: int) -> dict:
    """The sweep engine's fan-out for Experiment 1: none (this process)
    with one shard; else ``"process"``, a pool of ``SHARDS`` spawned
    workers each building the host backend with ``reps``, or
    ``"devices"``, a worker process on each of up to ``SHARDS`` cards
    (each times the sweep's default of 3 repetitions)."""
    if SHARDS <= 1:
        return {}
    registry = _registry()
    if registry.backend_shard_mode(EXEC_BACKEND) == "process":
        return {"backend": "process", "shards": SHARDS,
                "runner_factory": functools.partial(
                    registry.make_backend, EXEC_BACKEND, reps=reps)}
    return {"backend": "devices", "shards": SHARDS,
            "exec_backend": EXEC_BACKEND, "device": DEVICE}


def fingerprint():
    """The configured backend's fingerprint (its default dtype)."""
    from repro_torch.core.profile_store import current_fingerprint
    dtype = _registry().backend_default_dtype(EXEC_BACKEND)
    return current_fingerprint(backend=EXEC_BACKEND, dtype=dtype,
                               device=DEVICE)


def open_atlas(spec_name: str, threshold: float):
    """The persistent atlas a driver streams into: the default atlas
    directory (``$REPRO_ATLAS_DIR`` or the shared cache), keyed by the
    configured backend's fingerprint, so a repeat run resumes and each
    backend's ground truth stays in its own atlas."""
    from repro_torch.core.sweep import AnomalyAtlas
    return AnomalyAtlas.open(spec_name, fingerprint(), threshold=threshold)


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    """One CSV row; ``derived`` gains the fingerprint's slug."""
    tag = f"fp={fingerprint().slug()}"
    print(f"{name},{us_per_call:.3f},{derived + ';' if derived else ''}{tag}")
    sys.stdout.flush()


def note(msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.stderr.flush()
