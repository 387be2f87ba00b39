"""Batched serving on the PyTorch port: prefill + decode with KV caches.

The counterpart of ``examples/serve_lm.py``: loads a smoke-scale
yi-9b-family model (random weights — the serving path is the product),
runs batched greedy generation and prints tokens/s. The 1-token decode
GEMMs are the skinny-matmul regime where kernel efficiency (not FLOPs)
dominates — the paper's thesis at serving time.

On the card the serve step is compiled as the reference jits it: captured
once in a CUDA graph (``compile_serve_step``, as ``serve.decode.generate``
does) and replayed for every token; on the CPU it runs eagerly.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""

import argparse
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.models import api
from repro_torch.serve.decode import (ServeState, compile_serve_step,
                                      make_serve_step)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--new-tokens", type=int, default=48)
    args = ap.parse_args()
    device = torch.device(args.device)
    cfg = get_smoke("yi_9b")
    params = api.init(cfg, seed=0, device=device)
    batch, max_s, new_tokens = 8, 128, args.new_tokens

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, 4))).to(
        device)

    caches = api.init_caches(params, cfg, batch, max_s)
    step = make_serve_step(cfg, temperature=0.0)
    state = ServeState(caches=caches, last_tokens=prompts[:, :1].clone(),
                       rng=torch.Generator(device=device).manual_seed(1))
    if device.type == "cuda":
        compiled = compile_serve_step(step, state, params)
        state, advance = compiled.state, compiled
    else:
        def advance():
            _, nxt = step(state, params)
            state.last_tokens.copy_(nxt)
            return nxt

    with torch.no_grad():
        # prefill (teacher-forced through the decode path — exact for all
        # families including SSM)
        for i in range(prompts.shape[1] - 1):
            advance()
            state.last_tokens.copy_(prompts[:, i + 1:i + 2])

        # timed decode
        outs = [advance().clone()]         # first token
        t0 = time.perf_counter()
        for _ in range(new_tokens - 1):
            outs.append(advance().clone())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    gen = torch.cat(outs, dim=1)
    tps = batch * (new_tokens - 1) / dt
    how = "captured" if device.type == "cuda" else "eager"
    print(f"generated {tuple(gen.shape)} tokens for batch={batch} on "
          f"{args.device} ({how} serve step)")
    if device.type == "cuda":
        print(f"card: {card_line()}")
    print(f"decode throughput: {tps:.1f} tokens/s "
          f"({dt/(new_tokens-1)*1e3:.1f} ms/step)")
    print("sample:", gen[0][:16].cpu().numpy())


if __name__ == "__main__":
    main()
