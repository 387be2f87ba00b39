"""Load-test the serving plan cache: concurrent synthetic request storms.

The port's counterpart of the reference's ``tools/loadtest.py``, over
:class:`repro_torch.serve.plan_cache.PlanService` (it lives in the
package because the port adds no file under ``tools/``). It drives
thousands of lookups from a thread pool and reports:

* **steady-state selection latency** — p50/p99 of cache-*hit* lookups,
  the per-request planner cost once shapes are warm (the gated number:
  a regression here is a lock convoy or key-build bloat);
* **cold selection latency** — first-touch misses (enumeration +
  ranking), the cost ``plan_warmup`` hides from first requests;
* **cache hit rate** over the storm;
* **coalescing effectiveness** — a barrier-synchronised burst of
  same-shape misses should run ONE enumeration.

Usage::

    PYTHONPATH=src python -m repro_torch.serve.loadtest --requests 2000 --threads 8
    PYTHONPATH=src python -m repro_torch.serve.loadtest --device cpu --gate-p99-us 5000

The service plans on the ``cuda`` backend on the card by default
(``--device cpu`` for the CPU). Exit status is non-zero iff a
``--gate-p99-us`` bound is violated.
"""

from __future__ import annotations

import argparse
import dataclasses
import random
import sys
import threading
import time
from typing import Dict, List, Sequence, Tuple

#: The default synthetic shape pool: decode-regime instances of the
#: serving zoo families (a small model's worth of distinct shapes).
DEFAULT_SHAPES: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
    ("decproj", (1, 256, 768)),
    ("decproj", (1, 256, 1024)),
    ("decproj", (8, 256, 768)),
    ("decattn", (1, 512, 64, 256)),
    ("decattn", (1, 1024, 64, 256)),
    ("decmlp", (1, 256, 1024)),
    ("decmlp", (8, 256, 1024)),
    ("decmlp", (1, 512, 2048)),
)


@dataclasses.dataclass
class LoadReport:
    requests: int
    threads: int
    wall_s: float
    hit_p50_us: float
    hit_p99_us: float
    miss_p50_us: float
    miss_p99_us: float
    hit_rate: float            # 0..1 over the storm phase
    throughput_rps: float
    coalesce_effectiveness: float   # 0..1 over the burst phase
    burst_misses: int          # enumerations actually run in the burst
    stats: Dict[str, int]      # final service counters


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _storm(service, schedule: List[Tuple[str, Tuple[int, ...]]],
           threads: int) -> Tuple[List[float], float]:
    """Run the schedule across a thread pool; returns (latencies_us, wall)."""
    chunks = [schedule[i::threads] for i in range(threads)]
    lat: List[List[float]] = [[] for _ in range(threads)]
    start = threading.Barrier(threads + 1)

    def worker(tid: int) -> None:
        mine, out = chunks[tid], lat[tid]
        start.wait()
        for family, dims in mine:
            t0 = time.perf_counter_ns()
            service.lookup(family, dims)
            out.append((time.perf_counter_ns() - t0) / 1e3)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    return [v for chunk in lat for v in chunk], wall


def coalescing_burst(make_service, threads: int = 16,
                     shape: Tuple[str, Tuple[int, ...]] = ("decmlp",
                                                           (3, 96, 384))
                     ) -> Tuple[float, int, int]:
    """Barrier-aligned same-shape miss burst on a FRESH service.

    Returns (effectiveness, misses, coalesced). With no coalescing every
    thread would enumerate; effectiveness is the fraction of potential
    duplicate enumerations avoided, ``(threads - misses)/(threads - 1)``
    — 1.0 means exactly one enumeration ran, whether the other threads
    parked on the in-flight marker (``coalesced``) or arrived after
    publication (lock-free hits). Both avoid the duplicate work.
    """
    service = make_service()
    family, dims = shape
    start = threading.Barrier(threads)

    def worker() -> None:
        start.wait()
        service.lookup(family, dims)

    ts = [threading.Thread(target=worker) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    stats = service.cache.stats()
    misses, coalesced = stats["misses"], stats["coalesced"]
    eff = (threads - misses) / max(1, threads - 1)
    return eff, misses, coalesced


def run_loadtest(service, *, requests: int = 2000, threads: int = 8,
                 shapes: Sequence[Tuple[str, Tuple[int, ...]]] =
                 DEFAULT_SHAPES, seed: int = 0,
                 make_service=None) -> LoadReport:
    """Cold phase + concurrent storm + coalescing burst → LoadReport.

    The cold phase touches every shape once single-threaded (those are
    the miss latencies); the storm then runs ``requests`` lookups over
    ``threads`` threads, all steady-state hits. ``make_service`` (a
    zero-arg factory) is used for the burst phase, which needs a fresh,
    cold cache; it defaults to a service of the same discriminant,
    backend and device.
    """
    rng = random.Random(seed)
    shapes = list(shapes)

    miss_us: List[float] = []
    for family, dims in shapes:           # cold: one miss per shape
        t0 = time.perf_counter_ns()
        service.lookup(family, dims)
        miss_us.append((time.perf_counter_ns() - t0) / 1e3)
    miss_us.sort()

    base = dict(service.cache.stats())
    schedule = [shapes[rng.randrange(len(shapes))] for _ in range(requests)]
    hit_us, wall = _storm(service, schedule, threads)
    hit_us.sort()
    after = service.cache.stats()
    storm_hits = after["hits"] - base["hits"]
    storm_lookups = after["lookups"] - base["lookups"]
    hit_rate = storm_hits / max(1, storm_lookups)

    if make_service is None:
        planner = service.planner

        def make_service():
            return type(service)(discriminant=planner.discriminant,
                                 backend=planner.backend,
                                 device=planner.device)
    eff, burst_misses, _ = coalescing_burst(make_service, threads=threads)

    return LoadReport(
        requests=requests, threads=threads, wall_s=wall,
        hit_p50_us=_percentile(hit_us, 0.50),
        hit_p99_us=_percentile(hit_us, 0.99),
        miss_p50_us=_percentile(miss_us, 0.50),
        miss_p99_us=_percentile(miss_us, 0.99),
        hit_rate=hit_rate,
        throughput_rps=requests / max(wall, 1e-9),
        coalesce_effectiveness=eff,
        burst_misses=burst_misses,
        stats=after,
    )


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.loadtest", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--discriminant", default="perfmodel")
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gate-p99-us", type=float, default=None,
                    help="fail (exit 1) if steady-state cache-hit "
                         "selection p99 exceeds this many microseconds")
    args = ap.parse_args(argv)

    from repro_torch.serve.plan_cache import PlanService

    def make_service() -> PlanService:
        return PlanService(discriminant=args.discriminant,
                           backend=args.backend, device=args.device)

    rep = run_loadtest(make_service(), requests=args.requests,
                       threads=args.threads, seed=args.seed,
                       make_service=make_service)
    print(f"requests={rep.requests} threads={rep.threads} "
          f"wall={rep.wall_s:.3f}s throughput={rep.throughput_rps:,.0f} rps",
          file=sys.stderr)
    print(f"selection hit   p50={rep.hit_p50_us:.1f}us "
          f"p99={rep.hit_p99_us:.1f}us (hit rate {rep.hit_rate:.1%})",
          file=sys.stderr)
    print(f"selection miss  p50={rep.miss_p50_us:.1f}us "
          f"p99={rep.miss_p99_us:.1f}us", file=sys.stderr)
    print(f"coalescing      effectiveness={rep.coalesce_effectiveness:.1%} "
          f"(burst enumerations: {rep.burst_misses})", file=sys.stderr)
    if args.gate_p99_us is not None and rep.hit_p99_us > args.gate_p99_us:
        print(f"GATE FAILED: cache-hit selection p99 {rep.hit_p99_us:.1f}us "
              f"> bound {args.gate_p99_us:.1f}us", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
