"""Wrapper of the hand-written Hopper flash attention (``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention.py:flash_attention_pallas``.
One block per (batch·head, 64-row query tile) streams 64-row K/V tiles
through shared memory with an online softmax in float32; GQA maps query
head ``h`` to kv head ``h // (H // Hkv)`` without repeating K/V. The
kernel reads q, k and v through their strides and writes the output
through the strides of a (B, H, S, D) view of a (B, S, H, D) buffer, so
the model's head transposes cost no copy. It masks a ragged S itself:
unlike the reference wrapper there is no block-divisibility fallback.
Its plain version is :func:`repro_torch.kernels.ref.flash_attention`.
"""

from __future__ import annotations

import torch

from . import _build

#: Head dims the kernel is instantiated for (the test configs' 16, phi3's
#: 96, gemma2's 256 and the powers of two between).
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
#: Input types and their codes in the C entry point.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Launches of the CUDA kernel in this process.
launches = 0


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, scale: float, logit_softcap: float,
                         window: int) -> torch.Tensor:
    """Attention on the card; operands already validated by
    ``ops.flash_attention``. Returns a (B, H, S, D) view whose storage is
    (B, S, H, D)-contiguous."""
    global launches
    b, h, s, d = q.shape
    hkv = k.shape[1]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    o = out.transpose(1, 2)
    if out.numel() == 0:
        return o
    lib = _build.library()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(
            DTYPES[q.dtype], d,
            q.data_ptr(), *q.stride(), k.data_ptr(), *k.stride(),
            v.data_ptr(), *v.stride(), o.data_ptr(), *o.stride(),
            b, h, hkv, s, float(scale), float(logit_softcap), int(causal),
            int(window), _build.stream(q.device))
    _build.check(rc, "flash_attention")
    launches += 1
    return o
