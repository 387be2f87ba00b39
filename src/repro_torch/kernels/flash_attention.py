"""Wrapper of the hand-written Hopper flash attention (``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention.py:flash_attention_pallas``.
bfloat16 runs on the tensor cores (``csrc/flash_attention_tc.cu``: one
block of 8 warps per (batch·head, 128-row query tile), ``mma.sync``
products, K/V tiles through a ``cp.async`` ring); float32 on the CUDA
cores (``csrc/flash_attention.cu``, 64-row tiles). Both keep the online
softmax in float32 and map query head ``h`` to kv head ``h // (H // Hkv)``
without repeating K/V. The kernels read q, k and v through their strides
and write the output through the strides of a (B, H, S, D) view of a
(B, S, H, D) buffer, so the model's head transposes cost no copy. They
mask a ragged S themselves: unlike the reference wrapper there is no
block-divisibility fallback. Its plain version is
:func:`repro_torch.kernels.ref.flash_attention`.

The bfloat16 kernel copies 16-byte rows: it needs D contiguous, 16-byte
aligned data and strides that are multiples of 8 elements. The model's
views meet that; for an operand that does not, and only then, the wrapper
makes a contiguous copy and counts it in :data:`copies`.
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
#: Operands the wrapper copied because the bfloat16 kernel could not read
#: them in place (see :func:`reads_in_place`).
copies = 0


def reads_in_place(t: torch.Tensor) -> bool:
    """Whether the bfloat16 kernel reads ``t`` (B, H, S, D) through its
    strides: D contiguous, 16-byte aligned, and the strides of the other
    dims (those longer than 1) multiples of 8 elements (16 bytes)."""
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st, size in zip(t.stride()[:3],
                                                     t.shape[:3])
                    if size > 1))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, scale: float, logit_softcap: float,
                         window: int) -> torch.Tensor:
    """Attention on the card; operands already validated by
    ``ops.flash_attention``. Returns a (B, H, S, D) view whose storage is
    (B, S, H, D)-contiguous."""
    global launches, copies
    if q.dtype == torch.bfloat16:
        in_place = [reads_in_place(t) for t in (q, k, v)]
        copies += in_place.count(False)
        q, k, v = (t if ok else t.contiguous()
                   for t, ok in zip((q, k, v), in_place))
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
