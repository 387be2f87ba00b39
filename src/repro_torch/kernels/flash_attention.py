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

Every call goes through the custom operator ``repro_torch::flash_attention``
(the kernel on the card, the plain version on the CPU), whose fake
implementation and FLOP formula let a dry-run trace it under
``FakeTensorMode`` and count it as the attention it is. On DTensors (a
sharded prefill, :func:`flash_attention_sharded`) it runs on each rank's
local shards in the reference's ``shard_heads`` layout: batch over the
data axes, query heads over ``model``, the full sequence.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import register_flop_formula

from . import _build, ref

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


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float, logit_softcap: float,
              window: int) -> torch.Tensor:
    """Attention of plain tensors, the one entry of every call: the kernel
    on the card, the plain version on the CPU, both as a (B, H, S, D) view
    of a (B, S, H, D) buffer. Any other device with storage raises; meta
    and fake tensors take the fake implementation below."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                    logit_softcap=logit_softcap,
                                    window=window)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for device "
                         f"{q.device}")
    out = ref.flash_attention(q, k, v, causal=causal, scale=scale,
                              logit_softcap=logit_softcap, window=window)
    # the kernel's output layout: a (B, H, S, D) view of (B, S, H, D)
    return out.transpose(1, 2).contiguous().transpose(1, 2)


@_flash_op.register_fake
def _(q, k, v, causal, scale, logit_softcap, window):
    b, h, s, d = q.shape
    return q.new_empty((b, s, h, d)).transpose(1, 2)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
                 **kwargs) -> int:
    """Q·Kᵀ and P·V over every (query, key) pair: 4·B·H·Sq·Sk·D, the
    convention of ``torch.utils.flop_counter``'s attention formulas
    (masked pairs counted too)."""
    b, h, sq, d = q_shape
    return 4 * b * h * sq * k_shape[2] * d


def flash_attention_sharded(q: DTensor, k: DTensor, v: DTensor, *,
                            causal: bool, scale: float,
                            logit_softcap: float, window: int) -> DTensor:
    """Attention of DTensors q (B, H, S, D), k/v (B, Hkv, S, D): each rank
    runs the kernel on its batch rows and query heads with the whole
    sequence, and the KV heads they read
    (:func:`repro_torch.sharding.context.attention_shards`)."""
    from repro_torch.sharding.context import attention_shards
    ql, kl, vl, qp = attention_shards(q, k, v, head_dim=1)
    out = torch.ops.repro_torch.flash_attention(
        ql, kl, vl, causal, float(scale), float(logit_softcap), int(window))
    return DTensor.from_local(out, q.device_mesh, qp, run_check=False)
