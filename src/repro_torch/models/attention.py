"""GQA attention with full / flash / sliding-window variants + KV cache.

Counterpart of the reference's ``models/attention.py``:

* ``apply_train`` — full sequence, causal (or bidirectional); with
  ``differentiable=False`` (prefill) it runs the hand-written flash
  kernel when the sequence is a multiple of 128 and at least 256, else
  masked dense attention — the reference's routing exactly. A
  differentiable call (training) takes :func:`chunked_attention`, the
  blockwise scan with its own backward (``_ChunkedCore``), from
  ``CHUNKED_THRESHOLD`` positions on (a multiple of 512), and masked
  dense attention below. The flash kernel has no backward and is never on
  the training path.
* ``apply_prefill`` — the same forward, writing K/V into the cache.
* ``apply_decode`` — one new token against the cache.
* ``apply_cross`` / ``project_kv`` — cross-attention against an encoder's
  K/V (the encdec decoder): masked dense attention, neither causal nor
  windowed, with no flash call and no planner consult, as in the
  reference.

Caches are updated in place (the reference returns new arrays): a
serving loop owns its cache, and a functional update would copy all of
it every token (~0.4 GB for Yi-9B serving 2 × 2176 tokens).

Inside :func:`repro_torch.sharding.context.activation_sharding` the
projections take the reference's ``shard_heads`` layout (batch over
the data axes, heads over ``model``, the full sequence), the flash
kernel runs on each rank's local heads (:func:`repro_torch.kernels.ops.
flash_attention`), and a DTensor KV cache (sequence over ``model``) is
written shard by shard and read with a masked softmax over all its
positions, the reference's sharded-KV decode. Outside it the hooks are
the identity.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops as kops
from repro_torch.serve.plan_cache import default_plan_service, planner_enabled
from repro_torch.sharding.context import (attention_shards, grad_in_layout,
                                          shard_heads, shard_offset,
                                          whole_within)

from .layers import Dense, apply_rope, dense, softcap


class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0      # gemma2: 50.0
    window: int = 0                 # 0 = global; >0 = sliding window
    causal: bool = True
    use_flash: bool = True
    query_pre_scale: Optional[float] = None  # gemma2 scales by head_dim**-.5


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, max_s, Hkv, Dh)
    v: torch.Tensor     # (B, max_s, Hkv, Dh)
    length: int         # tokens currently valid
    #: Decode's P·V·Wo association, resolved once for the cache's
    #: capacity (:func:`planned_pv_right_first`); False is left.
    right_first: bool = False


class Attention(nn.Module):
    def __init__(self, cfg: AttnConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        hd = cfg.head_dim
        self.wq = Dense(cfg.d_model, cfg.n_heads * hd, ("embed", "heads"),
                        **kw)
        self.wk = Dense(cfg.d_model, cfg.n_kv_heads * hd,
                        ("embed", "kv_heads"), **kw)
        self.wv = Dense(cfg.d_model, cfg.n_kv_heads * hd,
                        ("embed", "kv_heads"), **kw)
        self.wo = Dense(cfg.n_heads * hd, cfg.d_model, ("heads", "embed"),
                        **kw)


def _whole_parts(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` ready to have ``dim`` split into ``n`` parts: a DTensor that
    shards ``dim`` over a mesh dim not dividing ``n`` is gathered on it
    (Yi-9B's 4 KV heads on a 16-wide ``model`` axis)."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim
          and n % mesh.size(i) else p for i, p in enumerate(t.placements)]
    return t if pl == list(t.placements) else t.redistribute(mesh, pl)


def _split_heads(t: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """(B, S, n·dh) → (B, S, n, dh)."""
    b, s, _ = t.shape
    return _whole_parts(t, 2, n).view(b, s, n, dh)


def _project_qkv(p: Attention, cfg: AttnConfig, x: torch.Tensor,
                 positions: torch.Tensor, rope: Optional[Tuple]):
    b, s, _ = x.shape
    q = _split_heads(dense(p.wq, x), cfg.n_heads, cfg.head_dim)
    k = _split_heads(dense(p.wk, x), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(dense(p.wv, x), cfg.n_kv_heads, cfg.head_dim)
    q, k, v = shard_heads(q), shard_heads(k), shard_heads(v)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
    return q, k, v


def _per_rank(core, q, k, v) -> torch.Tensor:
    """``core(q, k, v)`` (B, S, H, Dh) on each rank's batch rows and heads
    with the whole sequence (:func:`~repro_torch.sharding.context.
    attention_shards`) when q is a DTensor; as it is otherwise."""
    if not isinstance(q, DTensor):
        return core(q, k, v)
    ql, kl, vl, qp = attention_shards(q, k, v)
    return DTensor.from_local(core(ql, kl, vl), q.device_mesh, qp,
                              run_check=False)


def _dense_attention(cfg: AttnConfig, q, k, v) -> torch.Tensor:
    """Masked dense attention; q: (B,Sq,H,Dh), k/v: (B,Sk,Hkv,Dh)."""
    return _per_rank(lambda q, k, v: _dense_core(cfg, q, k, v), q, k, v)


def _dense_core(cfg: AttnConfig, q, k, v) -> torch.Tensor:
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    group = h // k.shape[2]
    scale = cfg.query_pre_scale or dh ** -0.5
    kq = k.repeat_interleave(group, dim=2)
    vq = v.repeat_interleave(group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kq.float()) * scale
    logits = softcap(logits, cfg.logit_softcap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if cfg.causal:
        mask &= qpos >= kpos
    if cfg.window > 0:
        mask &= qpos - kpos < cfg.window
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1).to(vq.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, vq)


def _attn_mask(sq: int, block: int, start: int, causal: bool, window: int,
               device) -> torch.Tensor:
    """(Sq, block) visibility of keys start..start+block-1."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = start + torch.arange(block, device=device)[None, :]
    mask = torch.ones((sq, block), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    return mask


def _chunked_forward(q, kq, vq, scale: float, causal: bool, window: int,
                     logit_softcap: float, block: int):
    """The online-softmax scan over key blocks: q (B,Sq,H,Dh), kq/vq
    (B,Sk,H,Dh) → (out (B,H,Sq,Dh) fp32, lse (B,H,Sq)). A row whose keys
    so far are all masked accumulates exp(0) terms that the first visible
    key's rescaling (alpha = 0) wipes, as in the reference's scan."""
    b, sq, h, dh = q.shape
    qf = q.float().transpose(1, 2)                   # (B,H,Sq,Dh)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for start in range(0, kq.shape[1], block):
        kblk = kq[:, start:start + block].float()
        vblk = vq[:, start:start + block].float()
        s = torch.einsum("bhqd,bkhd->bhqk", qf, kblk) * scale
        s = softcap(s, logit_softcap)
        mask = _attn_mask(sq, block, start, causal, window, q.device)
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                    vblk)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return acc / l[..., None], m + torch.log(l)


class _ChunkedCore(torch.autograd.Function):
    """Flash-style attention with a hand-written backward, the reference's
    ``_chunked_core`` custom VJP: the backward recomputes P blockwise from
    (q, k, v, out, lse) instead of saving the S×S probabilities, so both
    directions hold O(S·block) of them. Inputs are (B, S, H, Dh) with the
    keys' heads already repeated to H; the output is in q's dtype."""

    @staticmethod
    def forward(ctx, q, kq, vq, scale, causal, window, logit_softcap, block):
        out, lse = _chunked_forward(q, kq, vq, scale, causal, window,
                                    logit_softcap, block)
        ctx.save_for_backward(q, kq, vq, out, lse)
        ctx.args = (scale, causal, window, logit_softcap, block)
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, kq, vq, out, lse = ctx.saved_tensors
        scale, causal, window, cap, block = ctx.args
        sq = q.shape[1]
        qf = q.float().transpose(1, 2)               # (B,H,Sq,Dh)
        gf = g.float().transpose(1, 2)
        # D_i = Σ_d dout_i · out_i  (flash backward identity)
        delta = (gf * out).sum(dim=-1)               # (B,H,Sq)
        dq = torch.zeros_like(qf)
        dks, dvs = [], []
        for start in range(0, kq.shape[1], block):
            kf = kq[:, start:start + block].float()
            vf = vq[:, start:start + block].float()
            s = torch.einsum("bhqd,bkhd->bhqk", qf, kf) * scale
            if cap > 0:
                t = torch.tanh(s / cap)
                s = cap * t
            mask = _attn_mask(sq, block, start, causal, window, q.device)
            s = s.masked_fill(~mask, -1e30)
            p = torch.exp(s - lse[..., None])        # (B,H,Sq,block)
            dv = torch.einsum("bhqk,bhqd->bkhd", p, gf)
            dp = torch.einsum("bhqd,bkhd->bhqk", gf, vf)
            ds = p * (dp - delta[..., None])         # ∂L/∂(capped logits)
            if cap > 0:
                ds = ds * (1.0 - t * t)              # soft-cap chain rule
            ds = ds * scale
            dq = dq + torch.einsum("bhqk,bkhd->bhqd", ds, kf)
            dk = torch.einsum("bhqk,bhqd->bkhd", ds, qf)
            # Per-block dk/dv rounded to bf16, as the reference does (its
            # partial sums cross the model axis under sequence
            # parallelism, at half the width).
            dks.append(dk.to(torch.bfloat16))
            dvs.append(dv.to(torch.bfloat16))
        dq = dq.transpose(1, 2).to(q.dtype)
        dk = torch.cat(dks, dim=1).to(kq.dtype)
        dv = torch.cat(dvs, dim=1).to(vq.dtype)
        return dq, dk, dv, None, None, None, None, None


def chunked_attention(cfg: AttnConfig, q, k, v, block: int = 512
                      ) -> torch.Tensor:
    """Flash-style attention with its own backward (O(S·block) memory
    forward and backward): q (B,Sq,H,Dh), k/v (B,Sk,Hkv,Dh) →
    (B,Sq,H,Dh). GQA keys are repeated to H heads before the core, so
    their gradient sums back through the repeat."""
    sk = k.shape[1]
    if sk % block:
        raise ValueError(f"chunked attention: {sk} keys are not a multiple "
                         f"of the block {block}")
    scale = cfg.query_pre_scale or q.shape[-1] ** -0.5
    args = (scale, cfg.causal, cfg.window, cfg.logit_softcap, block)

    def core(q, k, v):
        group = q.shape[2] // k.shape[2]
        return _ChunkedCore.apply(q, k.repeat_interleave(group, dim=2),
                                  v.repeat_interleave(group, dim=2), *args)

    return _per_rank(core, q, k, v)


# Sequence length above which training uses the chunked (flash-style)
# attention instead of materializing the S×S logits.
CHUNKED_THRESHOLD = 2048


def apply_train(p: Attention, cfg: AttnConfig, x: torch.Tensor,
                rope: Optional[Tuple] = None,
                positions: Optional[torch.Tensor] = None,
                return_kv: bool = False,
                differentiable: bool = True):
    """Full-sequence attention (training forward / prefill compute).

    ``differentiable=False`` (inference prefill) routes through the flash
    kernel; the (B, S, H, D) projections go in as (B, H, S, D) views and
    the kernel's output comes back (B, S, H, D)-contiguous, so neither
    transpose copies on the card.
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, cfg, x, positions, rope)
    use_flash = (not differentiable and cfg.use_flash
                 and s % 128 == 0 and s >= 256)
    if use_flash:
        scale = cfg.query_pre_scale or cfg.head_dim ** -0.5
        out = kops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=cfg.causal, scale=scale,
            logit_softcap=cfg.logit_softcap, window=cfg.window,
        ).transpose(1, 2)
    elif s >= CHUNKED_THRESHOLD and s % 512 == 0:
        out = chunked_attention(cfg, q, k, v)
    else:
        out = _dense_attention(cfg, q, k, v)
    out = grad_in_layout(out.reshape(b, s, cfg.n_heads * cfg.head_dim))
    proj = dense(p.wo, out)
    if return_kv:
        return proj, (k, v)
    return proj


def apply_prefill(p: Attention, cfg: AttnConfig, x: torch.Tensor,
                  cache: KVCache, rope: Optional[Tuple] = None
                  ) -> Tuple[torch.Tensor, KVCache]:
    """Prefill attention; K/V are stored at positions 0..S-1 in place."""
    s = x.shape[1]
    proj, (k, v) = apply_train(p, cfg, x, rope=rope, return_kv=True,
                               differentiable=False)
    write_positions(cache.k, k, 0)
    write_positions(cache.v, v, 0)
    return proj, cache._replace(length=s)


def write_positions(buf: torch.Tensor, new: torch.Tensor,
                    start: int) -> None:
    """``buf[:, start:start + n] = new`` for a cache ``buf`` (B, S, ...)
    and ``new`` (B, n, ...), in place. A DTensor cache whose sequence is
    sharded is written shard by shard: each rank stores the positions
    that fall in its own shard (``new`` gathered to the cache's layout
    with its positions whole)."""
    n = new.shape[1]
    if not isinstance(buf, DTensor):
        buf[:, start:start + n] = new
        return
    mesh = buf.device_mesh
    layout = [Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
              for pl in buf.placements]
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    new_l = new.redistribute(mesh, layout).to_local()
    local = buf.to_local()
    off = shard_offset(buf.shape, mesh, buf.placements, 1)
    length = local.shape[1]
    lo, hi = max(start, off), min(start + n, off + length)
    if lo < hi:
        local[:, lo - off:hi - off] = new_l[:, lo - start:hi - start]


def planned_pv_right_first(t: int, s: int, head_dim: int, d_model: int,
                           device="cuda") -> bool:
    """Planner consult: associate decode P·V·Wo right-first?

    The decode value→output tail is a 3-matrix chain per head —
    P (t×s) · V (s×head_dim) · Wo (head_dim×d_model), the ``decattn`` zoo
    family — with two association orders. This asks the serving plan
    cache (:mod:`repro_torch.serve.plan_cache`, the default service of
    ``device``) which order its discriminant ranks first. The reference
    consults at trace time with the cache buffer's length; the port
    consults once per KV cache, with its capacity as ``s``
    (:func:`repro_torch.models.transformer.plan_decode`, a plan-cache hit
    after :func:`repro_torch.serve.decode.plan_warmup`), and carries the
    answer in :attr:`KVCache.right_first`: a decode step makes no lookup.

    Selection must never take down the serving path: any failure, or the
    ``REPRO_SERVE_PLANNER=0`` kill-switch, gives the left association.
    For decode geometries (t = 1, head_dim ≤ d_model) every shipped
    policy picks left — right costs s·head_dim·d_model multiply-adds per
    head against left's s·head_dim.
    """
    if not planner_enabled():
        return False
    try:
        plan = default_plan_service(device).lookup(
            "decattn", (t, s, head_dim, d_model))
        first = plan.algorithm.calls[0]
        # Right-first iff the first GEMM is V·Wo (its rows are the s axis).
        return s != t and first.dims[0] == s
    except Exception as e:   # noqa: BLE001 — serving must go on
        warnings.warn(f"decode plan consult failed ({e!r}); using the left "
                      f"association", RuntimeWarning, stacklevel=2)
        return False


def pv_wo_output(p_attn: torch.Tensor, v: torch.Tensor, wo: Dense,
                 n_heads: int, head_dim: int, out_dtype,
                 right_first: bool = False) -> torch.Tensor:
    """Decode value→output tail, associated as the planner chose for the
    KV cache (``right_first``, :attr:`KVCache.right_first`).

    ``p_attn`` (B, H, 1, K) are the softmax probabilities and ``v``
    (B, K, Hkv, head_dim) the cached values. Query head ``h`` reads kv
    head ``h // (H // Hkv)``: the same products as the reference's
    head-expanded ``repeat``, without copying the cache. Left is
    ``(P·V)·Wo``; right applies Wo, viewed (Hkv, group, head_dim,
    d_model), to V per head first. Both contract the same operands, so
    they agree up to float reassociation.
    """
    b, _, _, kk = p_attn.shape
    hkv = v.shape[2]
    group = n_heads // hkv
    pg = _whole_parts(p_attn, 1, hkv).reshape(b, hkv, group, kk)
    d_model = wo.w.shape[1]
    if right_first:
        w4 = wo.w.to(p_attn.dtype).reshape(hkv, group, head_dim, d_model)
        vwo = torch.einsum("bkhd,hgde->bkhge", v.to(p_attn.dtype), w4)
        out = torch.einsum("bhgk,bkhge->be", pg, vwo)
        return out.reshape(b, 1, d_model).to(out_dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", pg, v.to(p_attn.dtype))
    out = out.reshape(b, 1, n_heads * head_dim)
    return dense(wo, out.to(out_dtype))


def apply_decode(p: Attention, cfg: AttnConfig, x: torch.Tensor,
                 cache: KVCache, rope: Optional[Tuple] = None
                 ) -> Tuple[torch.Tensor, KVCache]:
    """One-token step: x (B, 1, d). K/V are written into the cache at
    ``length`` (in place), then the new token attends to positions
    0..length (the last ``window`` of them if ``window`` > 0).

    The cache quantizes *storage* only (bf16 k/v): the contraction runs
    at activation precision, float32 logits and probabilities, as in the
    reference. Only the visible slice of the cache is read; the reference
    masks the rest with -1e30, whose softmax weights are exactly zero.
    """
    b, s1, _ = x.shape
    if s1 != 1:
        raise ValueError(f"apply_decode takes one token per sequence, got "
                         f"x of shape {tuple(x.shape)}")
    idx = cache.length
    if idx >= cache.k.shape[1]:
        raise ValueError(f"KV cache full: length {idx} of "
                         f"{cache.k.shape[1]} positions")
    pos = torch.full((b, 1), idx, device=x.device, dtype=torch.long)
    q, k, v = _project_qkv(p, cfg, x, pos, rope)
    lo = max(0, idx + 1 - cfg.window) if cfg.window > 0 else 0
    if isinstance(cache.k, DTensor):
        write_positions(cache.k, k, idx)
        write_positions(cache.v, v, idx)
    else:
        cache.k[:, idx] = k[:, 0]
        cache.v[:, idx] = v[:, 0]
    # a sequence split across ranks is read whole, the positions outside
    # lo..idx masked (their softmax weights are exactly zero)
    sharded = isinstance(cache.k, DTensor) and \
        cache.k.to_local().shape[1] != cache.k.shape[1]
    keys = cache.k if sharded else cache.k[:, lo:idx + 1]   # (B,n,Hkv,Dh)
    vals = cache.v if sharded else cache.v[:, lo:idx + 1]
    hkv = cfg.n_kv_heads
    scale = cfg.query_pre_scale or cfg.head_dim ** -0.5
    qg = whole_within(_whole_parts(q, 2, hkv).reshape(
        b, hkv, cfg.n_heads // hkv, cfg.head_dim), 0, 1)  # einsum merges
    logits = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                          keys.to(q.dtype).float()) * scale
    logits = softcap(logits, cfg.logit_softcap)
    if sharded:
        kpos = torch.arange(keys.shape[1], device=x.device)
        logits = logits.masked_fill((kpos < lo) | (kpos > idx), -1e30)
    p_attn = torch.softmax(logits, dim=-1).reshape(b, cfg.n_heads, 1, -1)
    proj = pv_wo_output(p_attn, vals.to(q.dtype), p.wo, cfg.n_heads,
                        cfg.head_dim, x.dtype, right_first=cache.right_first)
    return proj, cache._replace(length=idx + 1)


def apply_cross(p: Attention, cfg: AttnConfig, x: torch.Tensor,
                enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """Cross-attention of x (B, S, d) against precomputed encoder K/V
    (B, S_enc, Hkv, Dh), every encoder position visible."""
    b, s, _ = x.shape
    q = _split_heads(dense(p.wq, x), cfg.n_heads, cfg.head_dim)
    out = _dense_attention(cfg._replace(causal=False, window=0), q, enc_k,
                           enc_v)
    return dense(p.wo, grad_in_layout(
        out.reshape(b, s, cfg.n_heads * cfg.head_dim)))


def project_kv(p: Attention, cfg: AttnConfig, enc: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V (B, S_enc, Hkv, Dh) of an encoder output."""
    k = _split_heads(dense(p.wk, enc), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(dense(p.wv, enc), cfg.n_kv_heads, cfg.head_dim)
    return k, v
