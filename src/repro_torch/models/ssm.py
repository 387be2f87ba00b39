"""Mamba2 / SSD layer — with the paper's algorithm selection built in.

Counterpart of the reference's ``models/ssm.py``. The SSD (state-space
duality) layer computes one sequence transformation

    h_t = exp(Δt·A)·h_{t-1} + Δt·B_t xₜᵀ ,   y_t = C_t·h_t

by either of two mathematically equivalent algorithms —

  * ``quadratic`` — materialize the (S×S) semiseparable kernel
    ``(C·Bᵀ ⊙ L)``; FLOPs ≈ 2·S²·(N+P) per head;
  * ``chunked`` — intra-chunk quadratic + inter-chunk recurrence;
    FLOPs ≈ 2·S·Q·(N+P) + 4·S·N·P.

``select_ssd_mode`` scores both with the ``flops`` discriminant or the
``perfmodel`` one, under the port's ``AnalyticalHopperProfile`` unless a
``profile`` is given. The reference carries the inter-chunk states with
``lax.associative_scan``; here a serial loop over the S/Q chunks computes
the same recurrence, the incoming state ``h0`` folded in first as the
reference does. Inside :func:`repro_torch.sharding.context.
activation_sharding` the chunk tensors run chunk-sharded over ``model``
and the inter-chunk states heads-sharded (``shard_ssd_chunks``,
``shard_ssd_states``), as in the reference, each stage on a rank's own
data (``local_map``); outside it the hooks are the identity. On the card
the intra-chunk stage is the fused kernel of
:mod:`repro_torch.kernels.ssd_chunk`; elsewhere it is :func:`_intra_chunks`.

Caches are updated in place, as the port's KV caches are.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.core.flops import gemm as gemm_call
from repro_torch.core.perfmodel import AnalyticalHopperProfile, KernelProfile
from repro_torch.kernels import ssd_chunk
from repro_torch.runtime import spans
from repro_torch.sharding.context import (batch_axes, grad_in_layout,
                                          placements_of, replicate,
                                          shard_ssd_chunks, shard_ssd_states)

from . import layers
from .layers import Dense, _normal, dense


class SSMConfig(NamedTuple):
    d_model: int
    d_inner: int          # = n_heads * head_dim (expand * d_model)
    n_heads: int
    head_dim: int
    n_groups: int
    d_state: int          # N
    conv_kernel: int = 4
    chunk: int = 128
    ssd_mode: str = "auto"   # auto | quadratic | chunked
    discriminant: str = "perfmodel"


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, K-1, conv_channels), layers stacked first
    state: torch.Tensor  # (B, H, N, P), layers stacked first
    length: torch.Tensor  # () int64 on the cache's device: tokens seen


# ------------------------------------------------- algorithm selection ---

def ssd_algorithm_calls(mode: str, s: int, n: int, p: int, q: int,
                        heads: int):
    """Each SSD form as a bag of GEMM calls for the cost model: heads ×
    chunks are batch dimensions of one batched product, so each step type
    is ONE call whose N dimension absorbs the batch (total FLOPs exact,
    overhead charged once per product), as in the reference."""
    if mode == "quadratic":
        return [gemm_call(s, s * heads, n), gemm_call(s, p * heads, s)]
    nc = max(1, s // q)
    batch = nc * heads
    return [
        gemm_call(q, q * batch, n),    # intra CBᵀ
        gemm_call(q, p * batch, q),    # intra (kernel)·X
        gemm_call(n, p * batch, q),    # chunk states  B·X
        gemm_call(q, p * batch, n),    # inter C·H
    ]


def select_ssd_mode(s: int, n: int, p: int, q: int, heads: int = 1,
                    discriminant: str = "perfmodel",
                    profile: Optional[KernelProfile] = None) -> str:
    """Choose the SSD algorithm with the paper's discriminants; the
    ``perfmodel`` score prices each call under ``profile`` (the port's
    :class:`AnalyticalHopperProfile` by default)."""
    prof = profile or AnalyticalHopperProfile()
    scores = {}
    for mode in ("quadratic", "chunked"):
        calls = ssd_algorithm_calls(mode, s, n, p, q, heads)
        if discriminant == "flops":
            scores[mode] = sum(c.flops for c in calls)
        else:
            scores[mode] = sum(prof.time(c, 2) for c in calls)
    mode = min(scores, key=scores.get)
    spans.count(f"ssm.ssd.mode.{mode}")
    return mode


# ------------------------------------------------------------- the math ---

def _masked_decay(diff: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """exp of the masked EXPONENT (not the product): exp of a masked
    entry could overflow to inf, and 0·inf is NaN."""
    return torch.exp(torch.where(mask, diff, torch.full_like(diff, -1e30)))


def ssd_quadratic(x, dt, a_log, bmat, cmat) -> torch.Tensor:
    """Dense semiseparable form. x:(B,S,H,P) dt:(B,S,H) a_log:(H,)
    bmat/cmat:(B,S,G,N). Returns (B,S,H,P). On DTensors each rank runs it
    on its batch rows (``local_map``): it mixes positions only."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        rows = list(placements_of(mesh, x.shape[:1], (batch_axes(),)))
        rep = [Replicate()] * mesh.ndim
        return local_map(_ssd_quadratic, out_placements=rows,
                         in_placements=(rows, rows, rep, rows, rows),
                         device_mesh=mesh, redistribute_inputs=True)(
            x, dt, a_log, bmat, cmat)
    return _ssd_quadratic(x, dt, a_log, bmat, cmat)


def _ssd_quadratic(x, dt, a_log, bmat, cmat) -> torch.Tensor:
    bsz, s, h, p = x.shape
    rep = h // bmat.shape[2]
    a = -torch.exp(a_log.float())                    # (H,) negative
    da = dt.float() * a                              # (B,S,H)
    cum = torch.cumsum(da, dim=1)                    # (B,S,H)
    # L[i,j] = exp(cum_i - cum_j), i >= j.
    diff = cum[:, :, None, :] - cum[:, None, :, :]   # (B,S,S,H)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                 device=x.device))
    L = _masked_decay(diff, mask[None, :, :, None])
    bh = bmat.repeat_interleave(rep, dim=2).float()  # (B,S,H,N)
    ch = cmat.repeat_interleave(rep, dim=2).float()
    scores = torch.einsum("bihn,bjhn->bijh", ch, bh)  # (B,S,S,H)
    kernel = scores * L
    xdt = x.float() * dt.float()[..., None]
    y = torch.einsum("bijh,bjhp->bihp", kernel, xdt)
    return y.to(x.dtype)


def _intra_chunks(xc, dtc, bc, cc, a):
    """Each chunk on its own: the within-chunk output, the state each
    chunk emits, its decay and the within-chunk cumulative decay, from
    (B,nc,Q,...) chunk tensors (B and C per group) and A (H,)."""
    q = xc.shape[2]
    bc, cc = _per_head(bc, xc), _per_head(cc, xc)
    da = dtc * a                                     # (B,nc,Q,H)
    cum = torch.cumsum(da, dim=2)                    # within-chunk cumsum
    total = cum[:, :, -1:, :]                        # (B,nc,1,H)

    # --- intra-chunk (quadratic within chunk) ---
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xc.device))
    L = _masked_decay(diff, mask[None, None, :, :, None])
    scores = torch.einsum("bcihn,bcjhn->bcijh", cc, bc)
    xdt = xc * dtc[..., None]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores * L, xdt)
    del diff, L, scores, xdt

    # --- chunk states ---
    decay_to_end = torch.exp(total - cum)            # (B,nc,Q,H)
    s_c = torch.einsum("bcqhn,bcqhp->bchnp",
                       bc * (decay_to_end * dtc)[..., None], xc)
    chunk_decay = torch.exp(total[:, :, 0, :])       # (B,nc,H)
    return y_intra, s_c, chunk_decay, cum


def _intra_kernel(xc, dtc, bc, cc, a):
    """:func:`_intra_chunks` on the card: the fused kernel
    (:func:`repro_torch.kernels.ssd_chunk.intra`) does the work of the
    (B,nc,Q,Q,H) forms and reads x, B and C in their own dtype; the
    (B,nc,Q,H) terms stay here."""
    cum = torch.cumsum(dtc * a, dim=2)
    total = cum[:, :, -1:, :]
    w = torch.exp(total - cum) * dtc
    y_intra, s_c = ssd_chunk.intra(xc, bc, cc, dtc, cum, w)
    return y_intra, s_c, torch.exp(total[:, :, 0, :]), cum


def _inter_chunks(s_c, chunk_decay, h0=None):
    """The recurrence H_c = d_c · H_{c-1} + S_c over the chunks → (the
    state entering each chunk (B,nc,H,N,P): h0, or zeros, first; the
    final state)."""
    state = h0 if h0 is not None else torch.zeros_like(s_c[:, 0])
    entering = []
    for c in range(s_c.shape[1]):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_c[:, c]
    return torch.stack(entering, dim=1), state


def _per_head(g, xc):
    """(B,nc,Q,G,N) group tensor → (B,nc,Q,H,N), each group's heads."""
    return g.repeat_interleave(xc.shape[3] // g.shape[3], dim=3)


def _chunk_outputs(y_intra, cc, cum, h_prev):
    """The within-chunk output plus what the entering states contribute
    (C per group)."""
    cc = _per_head(cc, y_intra)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           cc * torch.exp(cum)[..., None], h_prev)
    return y_intra + y_inter


def _sharded_stages(xc, with_h0: bool, stage):
    """The three stages of :func:`ssd_chunked` on each rank's own data
    (``local_map``), ``stage`` the intra-chunk one: the chunk stages in
    the reference's ``shard_ssd_chunks`` layout (batch over the data axes,
    chunks over ``model``), the recurrence in its ``shard_ssd_states``
    layout (heads over ``model``, every chunk); DTensor moves the states
    between the two."""
    mesh, bax = xc.device_mesh, batch_axes()
    b, nc, _, h = xc.shape[:4]
    chunks = list(placements_of(mesh, (b, nc), (bax, "model")))
    heads = list(placements_of(mesh, (b, 1, h), (bax, None, "model")))
    state = list(placements_of(mesh, (b, h), (bax, "model")))
    rep = [Replicate()] * mesh.ndim
    intra = local_map(stage, out_placements=(chunks,) * 4,
                      in_placements=(chunks,) * 4 + (rep,),
                      device_mesh=mesh, redistribute_inputs=True)
    inter = local_map(_inter_chunks, out_placements=(heads, state),
                      in_placements=(heads, heads,
                                     state if with_h0 else None),
                      device_mesh=mesh, redistribute_inputs=True)
    outputs = local_map(_chunk_outputs, out_placements=chunks,
                        in_placements=(chunks,) * 4, device_mesh=mesh,
                        redistribute_inputs=True)
    return intra, inter, outputs


def ssd_chunked(x, dt, a_log, bmat, cmat, chunk: int,
                h0: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Chunked SSD. Shapes as ssd_quadratic; S % chunk == 0.

    ``h0`` (B,H,N,P) optional incoming state; ``return_state`` also returns
    the final state (for prefill→decode handoff).
    """
    bsz, s, h, p = x.shape
    g, n = bmat.shape[2:]
    q = chunk
    nc = s // q
    a = -torch.exp(a_log.float())
    f32 = torch.float32
    # the kernel reads x, B and C as they come; the plain stage and the
    # inter-chunk stage take them in float32
    card = x.device.type == "cuda"
    stage = _intra_kernel if card else _intra_chunks
    spans.count("ssm.ssd.intra.kernel" if card else "ssm.ssd.intra.plain")

    xc = shard_ssd_chunks((x if card else x.to(f32)).reshape(
        bsz, nc, q, h, p))
    dtc = shard_ssd_chunks(dt.to(f32).reshape(bsz, nc, q, h))
    # B and C stay per group here; each stage repeats them to the heads
    bc = shard_ssd_chunks((bmat if card else bmat.to(f32)).reshape(
        bsz, nc, q, g, n))
    cc = shard_ssd_chunks(cmat.to(f32).reshape(bsz, nc, q, g, n))
    c_in = shard_ssd_chunks(cmat.reshape(bsz, nc, q, g, n)) if card else cc
    intra, inter, outputs = stage, _inter_chunks, _chunk_outputs
    if isinstance(xc, DTensor):
        intra, inter, outputs = _sharded_stages(xc, h0 is not None, stage)
        h0 = None if h0 is None else replicate(h0, xc.device_mesh)

    y_intra, s_c, chunk_decay, cum = spans.region_end(
        "ssm.ssd.intra",
        *intra(*spans.region("ssm.ssd.intra", xc, dtc, bc, c_in, a)))
    s_c = shard_ssd_states(s_c, h_axis=2)
    chunk_decay = shard_ssd_states(chunk_decay, h_axis=2)
    s_c, chunk_decay, h0, y_intra, cc, cum = spans.region(
        "ssm.ssd.inter", s_c, chunk_decay,
        h0.to(f32) if h0 is not None else None, y_intra, cc, cum)
    h_prev, state = inter(s_c, chunk_decay, h0)
    # one expression, as without the region: holding the float32 output in
    # a local until its cast changed which cached blocks the allocator
    # reused (0.77 GB more reserved at the H100 cell's peak)
    y, state = spans.region_end(
        "ssm.ssd.inter",
        outputs(y_intra, cc, cum, h_prev).reshape(bsz, s, h, p).to(x.dtype),
        state)
    if return_state:
        return y, state.to(x.dtype)
    return y


def ssd(x, dt, a_log, bmat, cmat, cfg: SSMConfig) -> torch.Tensor:
    """The SSD in the form ``cfg.ssd_mode`` names, or, for ``auto``,
    the one :func:`select_ssd_mode` picks; device region ``ssm.ssd``."""
    s = x.shape[1]
    q = min(cfg.chunk, s)
    mode = cfg.ssd_mode
    if mode == "auto":
        mode = select_ssd_mode(
            s, cfg.d_state, cfg.head_dim, q,
            heads=cfg.n_heads, discriminant=cfg.discriminant)
    x, dt, a_log, bmat, cmat = spans.region("ssm.ssd", x, dt, a_log, bmat,
                                            cmat)
    if mode == "quadratic" or s % q != 0:
        y = ssd_quadratic(x, dt, a_log, bmat, cmat)
    else:
        y = ssd_chunked(x, dt, a_log, bmat, cmat, q)
    return spans.region_end("ssm.ssd", y)


# ------------------------------------------------------------- the block ---

class Mamba2Mixer(nn.Module):
    """The reference's ``ssm.init`` tree: ``in_proj`` (d → 2·d_inner +
    2·G·N + H), ``out_proj`` (d_inner → d), ``conv_w`` (K, C) ~
    N(0, 1/K), ``conv_b`` zeros, ``a_log`` = log(linspace(1, 16, H)),
    ``dt_bias`` = softplus⁻¹ of a log-uniform draw in [1e-3, 1e-1],
    ``d_skip`` ones and ``norm`` (d_inner)."""

    def __init__(self, cfg: SSMConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        d, di = cfg.d_model, cfg.d_inner
        gn = cfg.n_groups * cfg.d_state
        conv_ch = di + 2 * gn
        self.in_proj = Dense(d, 2 * di + 2 * gn + cfg.n_heads,
                             ("embed", "inner"), **kw)
        self.out_proj = Dense(di, d, ("inner", "embed"), **kw)
        self.conv_w = _normal(generator, (cfg.conv_kernel, conv_ch),
                              cfg.conv_kernel ** -0.5, device, dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.conv_b = nn.Parameter(torch.zeros((conv_ch,), device=device,
                                               dtype=dtype),
                                   requires_grad=False)
        self.a_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, cfg.n_heads, **f32)).to(dtype), requires_grad=False)
        u = torch.rand((cfg.n_heads,), generator=generator, **f32)
        u = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
        self.dt_bias = nn.Parameter(torch.log(torch.expm1(torch.exp(u)))
                                    .to(dtype), requires_grad=False)
        self.d_skip = nn.Parameter(torch.ones((cfg.n_heads,), device=device,
                                              dtype=dtype),
                                   requires_grad=False)
        self.norm = layers.RMSNorm(di, device=device, dtype=dtype)
        self.param_axes = {"conv_w": ("conv_k", "inner"),
                           "conv_b": ("inner",), "a_log": ("heads",),
                           "dt_bias": ("heads",), "d_skip": ("heads",)}


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. seq (B,S,C), w (K,C). ``prev`` (B,K-1,C)
    supplies left context for decode."""
    k = w.shape[0]
    if prev is None:
        prev = seq.new_zeros((seq.shape[0], k - 1, seq.shape[2]))
    full = torch.cat([prev, seq], dim=1)
    out = torch.zeros_like(seq, dtype=torch.float32)
    for i in range(k):
        out = out + full[:, i:i + seq.shape[1], :].float() * w[i].float()
    return (out + b.float()).to(seq.dtype)


def _split_proj(cfg: SSMConfig, zxbcdt: torch.Tensor):
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    return z, xbc, dt


def _inputs(p: Mamba2Mixer, cfg: SSMConfig, xbc: torch.Tensor,
            dt_raw: torch.Tensor):
    """The activated conv output split into x (B,S,H,P), B and C
    (B,S,G,N), and Δt = softplus(dt + dt_bias) in float32."""
    bsz, s = xbc.shape[:2]
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    x = xbc[..., :di].reshape(bsz, s, cfg.n_heads, cfg.head_dim)
    bmat = xbc[..., di:di + gn].reshape(bsz, s, cfg.n_groups, cfg.d_state)
    cmat = xbc[..., di + gn:].reshape(bsz, s, cfg.n_groups, cfg.d_state)
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())
    return x, bmat, cmat, dt


def _output(p: Mamba2Mixer, cfg: SSMConfig, y: torch.Tensor,
            x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Skip connection, gated norm and the output projection."""
    bsz, s = y.shape[:2]
    y = y + x * p.d_skip.to(x.dtype)[None, None, :, None]
    y = grad_in_layout(y.reshape(bsz, s, cfg.d_inner))
    y = layers.rmsnorm(p.norm, y * F.silu(z))
    return dense(p.out_proj, y)


def apply_train(p: Mamba2Mixer, cfg: SSMConfig,
                u: torch.Tensor) -> torch.Tensor:
    """u: (B, S, d_model) → (B, S, d_model)."""
    z, xbc, dt_raw = _split_proj(cfg, dense(p.in_proj, u))
    xbc = F.silu(_causal_conv(xbc, p.conv_w, p.conv_b))
    x, bmat, cmat, dt = _inputs(p, cfg, xbc, dt_raw)
    y = ssd(x, dt, p.a_log, bmat, cmat, cfg)
    return _output(p, cfg, y, x, z)


def init_cache(cfg: SSMConfig, batch: int, dtype=torch.bfloat16,
               device=None, n_layers: Optional[int] = None) -> SSMCache:
    """Zeroed conv tail and state, stored in ``dtype`` (bfloat16 by
    default, as in the reference: decode rounds the state every step);
    ``n_layers`` stacks that many on a leading axis."""
    conv_ch = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
    lead = () if n_layers is None else (n_layers,)
    return SSMCache(
        conv=torch.zeros(lead + (batch, cfg.conv_kernel - 1, conv_ch),
                         dtype=dtype, device=device),
        state=torch.zeros(lead + (batch, cfg.n_heads, cfg.d_state,
                                  cfg.head_dim), dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.long, device=device),
    )


def apply_prefill(p: Mamba2Mixer, cfg: SSMConfig, u: torch.Tensor,
                  cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """Full-sequence forward (chunked SSD, S % min(chunk, S) == 0) that
    writes the conv tail and the final state into ``cache`` and sets its
    length to S, in place."""
    s = u.shape[1]
    z, xbc, dt_raw = _split_proj(cfg, dense(p.in_proj, u))
    # the pre-activation tail: decode convolves the raw xbc with it
    conv_tail = xbc[:, -(cfg.conv_kernel - 1):, :]
    xbc = F.silu(_causal_conv(xbc, p.conv_w, p.conv_b))
    x, bmat, cmat, dt = _inputs(p, cfg, xbc, dt_raw)
    y, final = ssd_chunked(x, dt, p.a_log, bmat, cmat, min(cfg.chunk, s),
                           return_state=True)
    out = _output(p, cfg, y, x, z)
    cache.conv.copy_(conv_tail)
    cache.state.copy_(final)
    cache.length.fill_(s)
    return out, cache


def apply_decode(p: Mamba2Mixer, cfg: SSMConfig, u: torch.Tensor,
                 cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """One-token step, O(1) in sequence length; the conv tail and the
    state are updated in ``cache`` in place (the state rounded to the
    cache's dtype). The length is left as it is: a stacked cache's layers
    share one, which the model's step advances once."""
    bsz, s1, _ = u.shape
    if s1 != 1:
        raise ValueError(f"apply_decode takes one token per sequence, got "
                         f"u of shape {tuple(u.shape)}")
    z, xbc, dt_raw = _split_proj(cfg, dense(p.in_proj, u))
    new_conv = torch.cat([cache.conv, xbc.to(cache.conv.dtype)],
                         dim=1)[:, 1:, :]
    xbc = F.silu(_causal_conv(xbc, p.conv_w, p.conv_b,
                              prev=cache.conv.to(xbc.dtype)))
    x, bmat, cmat, dt = _inputs(p, cfg, xbc, dt_raw)
    rep = cfg.n_heads // cfg.n_groups
    bh = bmat[:, 0].repeat_interleave(rep, dim=1).float()     # (B,H,N)
    ch = cmat[:, 0].repeat_interleave(rep, dim=1).float()
    dt = dt[:, 0]                                              # (B,H)
    a = -torch.exp(p.a_log.float())                            # (H,)
    decay = torch.exp(dt * a)                                  # (B,H)
    xf = x[:, 0].float()                                       # (B,H,P)
    upd = torch.einsum("bhn,bhp->bhnp", bh * dt[..., None], xf)
    state = cache.state.float() * decay[..., None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", ch, state)               # (B,H,P)
    y = y + xf * p.d_skip.float()[None, :, None]
    y = y.reshape(bsz, 1, cfg.d_inner).to(u.dtype)
    y = layers.rmsnorm(p.norm, y * F.silu(z))
    out = dense(p.out_proj, y)
    cache.conv.copy_(new_conv)
    cache.state.copy_(state)
    return out, cache
