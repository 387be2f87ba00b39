#!/usr/bin/env python3
"""Read the numbers that a cell's correctness check compares over many
seeds in one process, with the control beside them:

    python3 h100_bench/calibrate.py --workload <cell> --seeds 11,12,13
        [--control 3] [--fault half_batch]

Each seed runs the cell's set-up and a window of one step (the check
reads what set-up and the window produced), then the reference; the
first ``--control`` seeds also run the control, the reference in fp8 in
the program's place; ``--fault`` plants one of
``h100_bench/faults.py``'s faults under the timed path. One JSON line per
seed: the program's numbers with their limits, and the control's. The
limits in ``workloads/<cell>.json`` are set from these readings.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100_bench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--control", type=int, default=0,
                    help="how many of the seeds also run the control")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS),
                    help="plant this fault under the timed path")
    args = ap.parse_args(argv)
    harness.cache_environment()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        with faults.FAULTS[args.fault]() if args.fault else \
                contextlib.nullcontext():
            line = harness.run_cell(args.workload, seed, 0.0, False,
                                    control=i < args.control)
        print(json.dumps({"seed": seed, "correct": line["correct"],
                          "checks": line["checks"],
                          "control": line.get("control"),
                          "detail": line.get("detail")}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
