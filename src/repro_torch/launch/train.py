"""End-to-end training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --smoke --steps 20 --device cpu

``--smoke`` takes the reduced config; without it the full published
config is trained on the card. The launcher wires the synthetic data
pipeline, the checkpoint manager (``--ckpt``) and the train loop together
under a :class:`~repro_torch.runtime.supervisor.Supervisor`, which
restarts the loop from its latest checkpoint after a failure.

``--model-parallel N`` trains sharded: the launcher initialises a process
group (gloo on the CPU, NCCL on the card) from ``RANK``/``WORLD_SIZE``
and ``MASTER_ADDR``/``MASTER_PORT`` as ``torchrun`` sets them (a world
of one without them), builds the (world / N, N) ``("data", "model")``
mesh of :func:`~repro_torch.launch.mesh.make_host_mesh` and runs the
loop inside :func:`~repro_torch.sharding.context.activation_sharding`:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch glm4-9b \
      --smoke --steps 20 --device cpu --model-parallel 2
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import torch
import torch.distributed as dist

from repro_torch.configs import get, get_smoke, normalize
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.layers import resolve_device
from repro_torch.runtime.supervisor import RestartPolicy, Supervisor
from repro_torch.sharding.context import activation_sharding
from repro_torch.sharding.rules import axis_sizes
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

    device = resolve_device(args.device)
    mesh, owned = None, False
    if args.model_parallel > 1 or "WORLD_SIZE" in os.environ:
        owned = init_distributed(device)
        mesh = make_host_mesh(model=args.model_parallel)

    def run(attempt: int):
        sharding = activation_sharding(mesh) if mesh is not None \
            else contextlib.nullcontext()
        with sharding:
            return train_loop.train(
                cfg, source, args.steps, ckpt_dir=args.ckpt,
                optimizer=args.optimizer, peak_lr=args.lr, device=device,
                mesh=mesh)

    try:
        sup = Supervisor(RestartPolicy(max_restarts=args.max_restarts,
                                       backoff_s=0.1))
        state = sup.run(run)
        if mesh is None or dist.get_rank() == 0:
            where = "" if mesh is None else \
                f" on mesh {dict(axis_sizes(mesh))}"
            print(f"[train] done at step {state.step}{where}; "
                  f"restarts={sup.restarts}")
    finally:
        if owned:
            dist.destroy_process_group()
    return 0


def init_distributed(device) -> bool:
    """Initialise the default process group unless one is: NCCL on the
    card, gloo on the CPU, from torchrun's environment, or a world of one
    on an in-process store. Returns whether it made one; on the card
    each rank takes the card of its ``LOCAL_RANK``."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


if __name__ == "__main__":
    sys.exit(main())
