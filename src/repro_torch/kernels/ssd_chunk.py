"""Wrapper of the fused SSD intra-chunk kernel (``csrc/ssd_chunk.cu``).

Replaces no kernel of the reference package, whose SSD is plain ``jnp``:
it fuses the stage that :func:`repro_torch.models.ssm._intra_chunks`
computes with (B, nc, Q, Q, H) float32 tensors in device memory. Per
(batch, chunk) and head, from x (B, nc, Q, H, P), B and C (B, nc, Q, G, N)
and the float32 Δt, within-chunk cumulative decay ``cum`` and state weight
``w = exp(cum[Q-1] − cum)·Δt`` (B, nc, Q, H), it returns

* ``y_intra`` (B, nc, Q, H, P) = K·x, K[i, j] = (C·Bᵀ)[i, j]·exp(cum_i −
  cum_j)·Δt_j for j <= i, and
* the chunk states ``s_c`` (B, nc, H, N, P) = Bᵀ·(w ⊙ x),

both float32, and the gradients of x, B, C, Δt, ``cum`` and ``w``. The
kernel reads x, B and C in their own dtype (bfloat16 or float32) through
their strides, so the model's views of the conv output cost no copy; its
float32 operands keep float32's accuracy (three bf16 parts each, see the
source). :func:`intra` is a ``torch.autograd.Function`` on CUDA tensors
only: the plain version is ``_intra_chunks`` itself, which the model runs
on the CPU. (A ``torch.library`` custom operator's first call costs ~9 s
of Python on the card's host, a set-up the training step would pay.)
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

#: Input types of x, B and C and their codes in the C entry points.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Rows of the kernel's tiles; the backward's scratch pads Q to a multiple.
TILE = 64


def head_slices(heads: int, groups: int) -> int:
    """Parts the backward splits a group's heads into for its head sums
    (4 where they divide them), each summed in order, then added in order."""
    return next(s for s in (4, 2, 1) if (heads // groups) % s == 0)


#: CUDA launches in this process: one a forward, three a backward.
launches = 0


def check(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
          dt: torch.Tensor, cum: torch.Tensor, w: torch.Tensor) -> None:
    """Shapes the kernel takes, on any device: x (B, nc, Q, H, P), B and C
    (B, nc, Q, G, N), Δt, cum and w (B, nc, Q, H), H a multiple of G, and
    N and P multiples of 16 (the k16 steps) up to 256; on the card also
    the dtypes. A :class:`ValueError` names the dim it refuses."""
    kernel = "ssd_chunk"
    for name, t, dims in (("x", x, 5), ("bmat", bmat, 5), ("cmat", cmat, 5),
                          ("dt", dt, 4), ("cum", cum, 4), ("w", w, 4)):
        if t.dim() != dims:
            raise ValueError(f"{kernel}: {name} must have {dims} dims, got "
                             f"shape {tuple(t.shape)}")
    b, nc, q, h, p = x.shape
    g, n = bmat.shape[3:]
    for name, t in (("bmat", bmat), ("cmat", cmat)):
        if tuple(t.shape) != (b, nc, q, g, n):
            raise ValueError(f"{kernel}: {name} must be (B, nc, Q, G, N) = "
                             f"{(b, nc, q, g, n)}, got {tuple(t.shape)}")
    for name, t in (("dt", dt), ("cum", cum), ("w", w)):
        if tuple(t.shape) != (b, nc, q, h):
            raise ValueError(f"{kernel}: {name} must be (B, nc, Q, H) = "
                             f"{(b, nc, q, h)}, got {tuple(t.shape)}")
    if g == 0 or h % g:
        raise ValueError(f"{kernel}: heads H={h} are not a multiple of the "
                         f"groups G={g}")
    for dim, size in (("N", n), ("P", p)):
        if size % 16 or not 0 < size <= 256:
            raise ValueError(f"{kernel}: {dim}={size} must be a multiple of "
                             f"16 in [16, 256]")
    if len({t.device for t in (x, bmat, cmat, dt, cum, w)}) > 1:
        raise ValueError(f"{kernel}: operands on different devices")
    if x.device.type == "cuda":
        if x.dtype not in DTYPES or {bmat.dtype, cmat.dtype} != {x.dtype}:
            raise ValueError(f"{kernel}: x, bmat, cmat must share one dtype "
                             f"of {[str(d) for d in DTYPES]}, got {x.dtype}, "
                             f"{bmat.dtype}, {cmat.dtype}")
        if {dt.dtype, cum.dtype, w.dtype} != {torch.float32}:
            raise ValueError(f"{kernel}: dt, cum, w must be float32, got "
                             f"{dt.dtype}, {cum.dtype}, {w.dtype}")


def intra(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
          dt: torch.Tensor, cum: torch.Tensor,
          w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y_intra, s_c) of the chunk tensors on the card; differentiable in
    all six. A :class:`ValueError` refuses tensors on another device."""
    check(x, bmat, cmat, dt, cum, w)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk: runs on CUDA tensors only, got "
                         f"{x.device} (the CPU takes models.ssm."
                         f"_intra_chunks)")
    return _Intra.apply(x, bmat, cmat, dt, cum, w)


# ------------------------------------------------------------ the launches ---

def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel reads its rows in place as 16-byte pieces (the
    last dim contiguous, the base and the other strides 16-byte aligned),
    else a contiguous copy. The model's views of the conv output qualify."""
    per = 16 // t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(st % per == 0 for st, size in zip(t.stride()[:-1],
                                                    t.shape[:-1])
                  if size > 1))
    return t if ok else t.contiguous()


def _strided(*tensors: torch.Tensor) -> list:
    args = []
    for t in tensors:
        args += (t.data_ptr(), *t.stride()[:4])
    return args


def _dims(x: torch.Tensor, bmat: torch.Tensor) -> list:
    b, nc, q, h, p = x.shape
    return [b, nc, q, h, bmat.shape[3], bmat.shape[4], p]


def forward(x, bmat, cmat, dt, cum, w):
    """The forward kernel; operands already validated by :func:`check`."""
    global launches
    x, bmat, cmat = _readable(x), _readable(bmat), _readable(cmat)
    dt, cum, w = dt.contiguous(), cum.contiguous(), w.contiguous()
    b, nc, q, h, p = x.shape
    n = bmat.shape[4]
    y = torch.empty((b, nc, q, h, p), dtype=torch.float32, device=x.device)
    s = torch.empty((b, nc, h, n, p), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_ssd_chunk_fwd(
            DTYPES[x.dtype], *_strided(x, bmat, cmat), dt.data_ptr(),
            cum.data_ptr(), w.data_ptr(), y.data_ptr(), s.data_ptr(),
            *_dims(x, bmat), _build.stream(x.device))
    _build.check(rc, "ssd_chunk")
    launches += 1
    return y, s


def backward(x, bmat, cmat, dt, cum, w, y, dy, ds):
    """The three backward kernels; the gradients of x, B and C in their
    dtypes, of Δt, cum and w in float32."""
    global launches
    x, bmat, cmat = _readable(x), _readable(bmat), _readable(cmat)
    dt, cum, w, y, dy, ds = (t.contiguous() for t in (dt, cum, w, y, dy, ds))
    b, nc, q, h, p = x.shape
    g = bmat.shape[3]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    db = torch.empty(bmat.shape, dtype=bmat.dtype, device=x.device)
    dc = torch.empty(cmat.shape, dtype=cmat.dtype, device=x.device)
    ddt, dcum, dw = (torch.empty_like(dt) for _ in range(3))
    qp, sl = -(-q // TILE) * TILE, head_slices(h, g)
    dsg = torch.empty((b, nc, g, sl, qp, qp), dtype=torch.float32,
                      device=x.device)
    dst = torch.empty((b, nc, g, sl, qp, bmat.shape[4]),
                      dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_ssd_chunk_bwd(
            DTYPES[x.dtype], *_strided(x, bmat, cmat),
            *(t.data_ptr() for t in (dt, cum, w, y, dy, ds, dx, db, dc, ddt,
                                     dcum, dw, dsg, dst)),
            *_dims(x, bmat), sl, _build.stream(x.device))
    _build.check(rc, "ssd_chunk")
    launches += 3
    return dx, db, dc, ddt, dcum, dw


# ------------------------------------------------------------ the autograd ---

class _Intra(torch.autograd.Function):
    """The forward kernel and, for its gradient, the backward kernels."""

    @staticmethod
    def forward(ctx, x, bmat, cmat, dt, cum, w):
        y, s = forward(x, bmat, cmat, dt, cum, w)
        ctx.save_for_backward(x, bmat, cmat, dt, cum, w, y)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        return backward(*ctx.saved_tensors, dy, ds)
