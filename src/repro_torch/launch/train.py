"""End-to-end training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --smoke --steps 20 --device cpu

``--smoke`` takes the reduced config; without it the full published
config is trained on the card. The launcher wires the synthetic data
pipeline, the checkpoint manager (``--ckpt``) and the train loop together
under a :class:`~repro_torch.runtime.supervisor.Supervisor`, which
restarts the loop from its latest checkpoint after a failure. The port
trains on one card: ``--model-parallel`` above 1 needs the distribution
layer (ROADMAP A9) and exits with code 2.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.configs import get, get_smoke, normalize
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.runtime.supervisor import RestartPolicy, Supervisor
from repro_torch.train import loop as train_loop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "muon"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        print(f"--model-parallel {args.model_parallel}: the port trains on "
              f"one card; model parallelism comes with the distribution "
              f"layer (ROADMAP A9)", file=sys.stderr)
        return 2

    arch = normalize(args.arch)
    cfg = get_smoke(arch) if args.smoke else get(arch)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = ((cfg.encoder_seq, cfg.d_model), "float32")
    if cfg.family == "vlm":
        extra["vision_embeds"] = ((cfg.vision_tokens, cfg.d_model),
                                  "float32")
    source = SyntheticLM(cfg.vocab, args.seq, args.batch,
                         extra_specs=extra)

    def run(attempt: int):
        return train_loop.train(
            cfg, source, args.steps, ckpt_dir=args.ckpt,
            optimizer=args.optimizer, peak_lr=args.lr, device=args.device)

    sup = Supervisor(RestartPolicy(max_restarts=args.max_restarts,
                                   backoff_s=0.1))
    state = sup.run(run)
    print(f"[train] done at step {state.step}; restarts={sup.restarts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
