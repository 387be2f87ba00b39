"""Batched serving on the PyTorch port: prefill + decode with KV caches.

The counterpart of ``examples/serve_lm.py``: loads a smoke-scale
yi-9b-family model (random weights — the serving path is the product),
runs batched greedy generation and prints tokens/s. The 1-token decode
GEMMs are the skinny-matmul regime where kernel efficiency (not FLOPs)
dominates — the paper's thesis at serving time.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.models import api
from repro_torch.serve.decode import ServeState, make_serve_step


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
    state = ServeState(caches=caches, last_tokens=prompts[:, :1],
                       rng=torch.Generator(device=device).manual_seed(1))

    with torch.inference_mode():
        # prefill (teacher-forced through the decode path — exact for all
        # families including SSM)
        for i in range(prompts.shape[1] - 1):
            state, _ = step(state, params)
            state = state._replace(last_tokens=prompts[:, i + 1:i + 2])

        # timed decode
        state, tok = step(state, params)   # first token
        outs = [tok]
        t0 = time.perf_counter()
        for _ in range(new_tokens - 1):
            state, tok = step(state, params)
            outs.append(tok)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    gen = torch.cat(outs, dim=1)
    tps = batch * (new_tokens - 1) / dt
    print(f"generated {tuple(gen.shape)} tokens for batch={batch} on "
          f"{args.device}")
    print(f"decode throughput: {tps:.1f} tokens/s "
          f"({dt/(new_tokens-1)*1e3:.1f} ms/step)")
    print("sample:", gen[0][:16].cpu().numpy())


if __name__ == "__main__":
    main()
