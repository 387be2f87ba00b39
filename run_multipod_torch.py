"""Multi-pod dry-run of the PyTorch port: every (arch × shape) cell at
the (2, 16, 16) mesh, on a fake process group of 512 ranks, as the
memory proof (per-device peak bytes, with the roofline terms beside).

    PYTHONPATH=src python run_multipod_torch.py [--out dryrun_multi_pod_torch.json]

Resumes: cells already in ``--out`` are not traced again. Each cell is
written as it finishes (atomic rename), a failed one with its ``error``;
the exit code is 1 when any cell failed. The JAX package's
``run_multipod.py`` is the reference and stays as it is.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import ARCH_IDS, SHAPES  # noqa: E402
from repro_torch.launch.dryrun import run_cell, write_atomic  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="dryrun_multi_pod_torch.json")
    args = ap.parse_args(argv)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    results = [r for r in results if "error" not in r]
    done = {(r["arch_id"], r["shape"]) for r in results}
    # the largest training cells last, as the reference orders them
    cells = sorted(((a, s) for a in ARCH_IDS for s in SHAPES),
                   key=lambda c: (c[0] == "internvl2_76b"
                                  and c[1] == "train_4k",
                                  c[1] == "train_4k"))
    failures = 0
    for arch, shape in cells:
        if (arch, shape) in done:
            continue
        try:
            r = run_cell(arch, shape, True)
            if r.get("skipped"):
                print(f"[skip] {arch} x {shape}", flush=True)
            else:
                print(f"[ ok ] {arch} x {shape} x 2x16x16: trace="
                      f"{r['trace_s']}s peak="
                      f"{r['bytes_per_device']['peak_est'] / 2 ** 30:.2f}GiB",
                      flush=True)
        except Exception as e:   # noqa: BLE001 — record, go on
            failures += 1
            traceback.print_exc()
            r = {"arch": arch, "shape": shape, "mesh": "2x16x16",
                 "error": f"{type(e).__name__}: {e}"}
            print(f"[FAIL] {arch} x {shape}: {e}", flush=True)
        results.append(dict(r, arch_id=arch))
        write_atomic(args.out, results)
    print("done", len(results))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
