"""End to end on the PyTorch port: train a ~100M-parameter LM for
a few hundred steps.

The counterpart of ``examples/train_lm.py``: a mamba2-family model sized
to ~100M params (the paper's planner picks the SSD form per shape; Muon
orthogonalizes the 2-D weights via the planned AAᵀB chains), with
checkpoints and the crash-resume supervisor — kill the process mid-run
and rerun to watch it resume. ``--smoke`` trains the reduced
``mamba2_370m`` smoke config instead (seconds on the CPU).

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
      [--device cpu] [--smoke]
"""

import argparse
import os
import tempfile

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ModelConfig
from repro_torch.runtime.supervisor import RestartPolicy, Supervisor
from repro_torch.train import loop as train_loop


def model_100m() -> ModelConfig:
    """~100M params: 12 layers, d=768 mamba2 (SSD planner active)."""
    return ModelConfig(
        name="mamba2-100m", family="ssm", n_layers=12, d_model=768,
        vocab=50280, tied_embeddings=True,
        ssm=SSMConfig(d_model=768, d_inner=1536, n_heads=24, head_dim=64,
                      n_groups=1, d_state=64, conv_kernel=4, chunk=64,
                      ssd_mode="auto", discriminant="perfmodel"),
        max_seq=2048,
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--optimizer", default="muon",
                    choices=("adamw", "muon"))
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_train_lm_torch"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="train the mamba2_370m smoke config")
    args = ap.parse_args()

    cfg = configs.get_smoke("mamba2_370m") if args.smoke else model_100m()
    print(f"model: {cfg.name} — {cfg.param_count()/1e6:.1f}M params, "
          f"optimizer={args.optimizer}, device={args.device}")

    src = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0)

    def run(attempt):
        return train_loop.train(
            cfg, src, args.steps, ckpt_dir=args.ckpt, save_every=50,
            optimizer=args.optimizer, peak_lr=3e-4, warmup=20,
            log_every=10, device=args.device)

    state = Supervisor(RestartPolicy(max_restarts=3)).run(run)
    print(f"finished at step {int(state.step)}")


if __name__ == "__main__":
    main()
