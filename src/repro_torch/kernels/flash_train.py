"""Wrapper of the training attention kernels (``csrc/flash_train.cu``).

Replaces no kernel of the reference package, whose training attention
(``src/repro/models/attention.py:_chunked_core``) is plain ``jnp``: it
computes on the card what :class:`repro_torch.models.attention.
_ChunkedCore`, the plain version, computes with float32 ATen einsums over
512-key blocks. From bf16 q (B, S, H, D) and k, v (B, S, Hkv, D), read
through their strides, :func:`attention` returns the bf16 output and, for
its gradient, dq, dk and dv: the softmax of ``scale``·q·kᵀ, soft-capped,
causal and windowed, its float32 output and log-sum-exp saved for the
backward, D_i = Σ dO·O taken from the float32 output. P and dS enter the
tensor-core products as three bf16 parts (see the source), dk and dv sum
the group's query heads in float32 and round once. Query head h reads kv
head h // (H // Hkv). Tile pairs that no query sees are skipped:
:func:`schedule` is the kernels' walk, for the CPU tests.

:func:`attention` is a ``torch.autograd.Function`` on CUDA tensors only;
the model takes ``_ChunkedCore`` on the CPU and for what :func:`check`
refuses (:func:`takes`). (A ``torch.library`` custom operator's first call
costs ~9 s of Python on the card's host, a set-up the training step would
pay.)
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from . import _build
from ._checks import check_same

#: Head dims the kernels are instantiated for.
HEAD_DIMS = (64, 128)
#: Rows of a block and of its inner step, by kernel and head dim: the
#: forward and dq walk key tiles for a query tile, dkdv query tiles (over
#: the group's heads) for a key tile. S must be a multiple of ROWS.
TILES = {d: {"fwd": (128, bk), "dq": (128, bk), "dkdv": (64, bk)}
         for d, bk in ((64, 64), (128, 32))}
ROWS = 128

#: CUDA launches in this process: one a forward, three a backward.
launches = 0


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          window: int = 0) -> None:
    """The operands the kernels take, on any device: bf16 q (B, S, H, D),
    k and v (B, S, Hkv, D) on one device, H a multiple of Hkv, D one of
    HEAD_DIMS, S a multiple of ROWS. A :class:`ValueError` names what it
    refuses."""
    kernel = "flash_train"
    operands = {"q": q, "k": k, "v": v}
    for name, t in operands.items():
        if t.dim() != 4:
            raise ValueError(f"{kernel}: {name} must be (B, S, H, D), got "
                             f"shape {tuple(t.shape)}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{kernel}: {name} must be bfloat16, got "
                             f"{t.dtype}")
    if len({t.device for t in operands.values()}) > 1:
        raise ValueError(f"{kernel}: operands on different devices")
    check_same(kernel, "batch dim B", ("q.shape[0]", q.shape[0]),
               ("k.shape[0]", k.shape[0]), ("v.shape[0]", v.shape[0]))
    check_same(kernel, "sequence dim S", ("q.shape[1]", q.shape[1]),
               ("k.shape[1]", k.shape[1]), ("v.shape[1]", v.shape[1]))
    check_same(kernel, "head_dim D", ("q.shape[3]", q.shape[3]),
               ("k.shape[3]", k.shape[3]), ("v.shape[3]", v.shape[3]))
    check_same(kernel, "kv heads Hkv", ("k.shape[2]", k.shape[2]),
               ("v.shape[2]", v.shape[2]))
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{kernel}: H={h} query heads are not a multiple "
                         f"of Hkv={hkv} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim D={d} is not one of the "
                         f"kernel's {list(HEAD_DIMS)}")
    if b == 0 or s == 0 or s % ROWS:
        raise ValueError(f"{kernel}: sequence dim S={s} (batch B={b}) must "
                         f"be a positive multiple of {ROWS}")
    if window < 0:
        raise ValueError(f"{kernel}: window={window} must be >= 0")


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          window: int = 0) -> bool:
    """Whether the kernels run this attention: CUDA operands that
    :func:`check` admits."""
    if q.device.type != "cuda":
        return False
    try:
        check(q, k, v, window)
    except ValueError:
        return False
    return True


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool = True, window: int = 0,
              logit_softcap: float = 0.0) -> torch.Tensor:
    """The attention (B, S, H, D) bf16 on the card, differentiable in q, k
    and v. A :class:`ValueError` refuses tensors on another device."""
    check(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_train: runs on CUDA tensors only, got "
                         f"{q.device} (the CPU takes models.attention."
                         f"_ChunkedCore)")
    return _Attention.apply(q, k, v, float(scale), bool(causal), int(window),
                            float(logit_softcap))


# ------------------------------------------------------------ the schedule ---

def key_tiles(q0: int, bq: int, bk: int, n_k: int, causal: bool,
              window: int) -> range:
    """Key tiles of size ``bk`` that the query tile [q0, q0 + bq) sees
    (``key_tiles`` of the source)."""
    last = min(n_k, (q0 + bq - 1) // bk + 1) if causal else n_k
    lo = q0 - window + 1
    return range(lo // bk if window > 0 and lo > 0 else 0, last)


def query_tiles(k0: int, bk: int, bq: int, n_q: int, causal: bool,
                window: int) -> range:
    """Query tiles of size ``bq`` that see the key tile [k0, k0 + bk)
    (``query_tiles`` of the source)."""
    first = k0 // bq if causal else 0
    last = min(n_q, (k0 + bk + window - 2) // bq + 1) if window > 0 else n_q
    return range(first, last)


def schedule(seq: int, heads: int, kv_heads: int, head_dim: int,
             causal: bool, window: int) -> dict:
    """The (query head, kv head, query rows, key rows) tile pairs each
    kernel visits, in its blocks' order: ``fwd`` and ``dq`` a block per
    (head, query tile) over its key tiles; ``dkdv`` a block per (kv head,
    key tile) over its group's heads and their query tiles. Rows are
    (first, one past the last)."""
    group = heads // kv_heads
    out = {}
    for name, (rows, step) in TILES[head_dim].items():
        visits: List[Tuple[int, int, Tuple[int, int], Tuple[int, int]]] = []
        if name == "dkdv":
            for hk in range(kv_heads):
                for k0 in range(0, seq, rows):
                    tiles = query_tiles(k0, rows, step, seq // step, causal,
                                        window)
                    for h in range(hk * group, (hk + 1) * group):
                        visits += [(h, hk, (t * step, (t + 1) * step),
                                    (k0, k0 + rows)) for t in tiles]
        else:
            for h in range(heads):
                for q0 in range(0, seq, rows):
                    visits += [(h, h // group, (q0, q0 + rows),
                                (t * step, (t + 1) * step))
                               for t in key_tiles(q0, rows, step, seq // step,
                                                  causal, window)]
        out[name] = visits
    return out


# ------------------------------------------------------------ the launches ---

def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernels read its rows in place as 16-byte pieces (D
    contiguous, the base and the other strides 16-byte aligned), else a
    contiguous copy. The model's projections qualify."""
    ok = (t.stride(3) == 1 and t.data_ptr() % 16 == 0
          and all(st % 8 == 0 for st, size in zip(t.stride()[:3],
                                                   t.shape[:3]) if size > 1))
    return t if ok else t.contiguous()


def _strided(*tensors: torch.Tensor) -> list:
    args = []
    for t in tensors:
        args += (t.data_ptr(), *t.stride()[:3])
    return args


def _dims(q, k, scale, causal, window, softcap) -> list:
    b, s, h, _ = q.shape
    return [b, h, k.shape[2], s, scale, softcap, int(causal), window]


def forward(q, k, v, scale, causal, window, softcap):
    """The forward kernel → (out bf16, out float32, lse (B, H, S) float32);
    operands already validated by :func:`check`."""
    global launches
    q, k, v = _readable(q), _readable(k), _readable(v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=q.device)
    out32 = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_train_fwd(
            d, *_strided(q, k, v), out.data_ptr(), out32.data_ptr(),
            lse.data_ptr(), *_dims(q, k, scale, causal, window, softcap),
            _build.stream(q.device))
    _build.check(rc, "flash_train")
    launches += 1
    return out, out32, lse


def backward(q, k, v, out32, lse, dout, scale, causal, window, softcap):
    """The three backward kernels → (dq, dk, dv), bf16."""
    global launches
    q, k, v, dout = (_readable(t) for t in (q, k, v, dout.to(torch.bfloat16)))
    b, s, h, d = q.shape
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.bfloat16, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.bfloat16, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_train_bwd(
            d, *_strided(q, k, v), out32.data_ptr(), lse.data_ptr(),
            *_strided(dout), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *_dims(q, k, scale, causal, window, softcap),
            _build.stream(q.device))
    _build.check(rc, "flash_train")
    launches += 3
    return dq, dk, dv


# ------------------------------------------------------------ the autograd ---

class _Attention(torch.autograd.Function):
    """The forward kernel and, for its gradient, the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        out, out32, lse = forward(q, k, v, scale, causal, window, softcap)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.args = (scale, causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = backward(*ctx.saved_tensors, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None
