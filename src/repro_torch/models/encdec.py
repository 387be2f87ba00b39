"""Encoder–decoder assembly (whisper-tiny backbone).

Counterpart of the reference's ``models/encdec.py``. The audio frontend
(log-mel and conv downsampling) is a stub: callers hand precomputed frame
embeddings (B, n_frames, d). Encoder blocks are bidirectional (no mask,
no RoPE, sinusoidal positions added to the frames); decoder blocks are
causal self-attention with RoPE, cross-attention against the encoder's
output and a plain GELU MLP; the embeddings are tied.

Serving runs the encoder once, in :func:`init_caches`, which stores each
decoder layer's cross K/V in the cache dtype beside zeroed self-attention
KV caches; :func:`apply_decode` casts the cross K/V back to the
activation dtype, as the reference does, and writes the self K/V in
place, as the port's other caches are written.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.sharding.context import shard_seq

from . import attention, layers
from .attention import KVCache
from .transformer import ModelConfig, _logits, maybe_remat, plan_kv


class EncDecCaches(NamedTuple):
    self_kv: KVCache          # stacked (L, B, max_s, Hkv, Dh)
    cross_k: torch.Tensor     # (L, B, S_enc, Hkv, Dh)
    cross_v: torch.Tensor


class EncoderBlock(nn.Module):
    """Pre-norms, bidirectional self-attention and a plain GELU MLP."""

    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        norm = dict(device=device, dtype=dtype)
        self.pre_attn_norm = layers.RMSNorm(cfg.d_model, **norm)
        self.attn = attention.Attention(cfg.attn_cfg, **kw)
        self.pre_mlp_norm = layers.RMSNorm(cfg.d_model, **norm)
        self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, **kw)


class DecoderBlock(nn.Module):
    """Causal self-attention, cross-attention and a plain GELU MLP, each
    after its pre-norm."""

    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        norm = dict(device=device, dtype=dtype)
        self.pre_attn_norm = layers.RMSNorm(cfg.d_model, **norm)
        self.attn = attention.Attention(cfg.attn_cfg, **kw)
        self.pre_cross_norm = layers.RMSNorm(cfg.d_model, **norm)
        self.cross = attention.Attention(cfg.attn_cfg, **kw)
        self.pre_mlp_norm = layers.RMSNorm(cfg.d_model, **norm)
        self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, **kw)


class EncDecLM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        norm = dict(device=device, dtype=dtype)
        self.embed = layers.Embed(cfg.padded_vocab, cfg.d_model, **kw)
        self.encoder = nn.ModuleList(
            EncoderBlock(cfg, **kw) for _ in range(cfg.encoder_layers))
        self.enc_norm = layers.RMSNorm(cfg.d_model, **norm)
        self.decoder = nn.ModuleList(
            DecoderBlock(cfg, **kw) for _ in range(cfg.n_layers))
        self.final_norm = layers.RMSNorm(cfg.d_model, **norm)


def init(cfg: ModelConfig, generator: Optional[torch.Generator], *,
         device, dtype=torch.float32) -> EncDecLM:
    """Weights from the reference's distributions, drawn from
    ``generator`` (which lies on ``device``; ``None`` only for ``meta``)."""
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name}: encdec.init takes the encdec family, "
                         f"not {cfg.family}")
    return EncDecLM(cfg, generator=generator, device=device, dtype=dtype)


def _sinusoid(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) positions: [sin | cos] of pos / 10000^(2i/d), concatenated
    (not interleaved), in float32."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(model: EncDecLM, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_enc, d) stub embeddings → encoder output, in the
    frames' dtype. Attention takes the reference's differentiable route
    (masked dense below the chunked threshold)."""
    x = frames + _sinusoid(frames.shape[1], cfg.d_model,
                           frames.device).to(frames.dtype)[None]
    acfg = cfg.attn_cfg._replace(causal=False)
    for bp in model.encoder:
        h = layers.rmsnorm(bp.pre_attn_norm, x)
        x = x + attention.apply_train(bp.attn, acfg, h, rope=None)
        h = layers.rmsnorm(bp.pre_mlp_norm, x)
        x = shard_seq(x + layers.mlp(bp.mlp, h))
    return layers.rmsnorm(model.enc_norm, x)


def _decoder_block(bp: DecoderBlock, acfg, x: torch.Tensor, attend,
                   enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """One decoder block around ``attend`` (normed input → self-attention
    output), cross-attending to ``enc_k``/``enc_v``."""
    x = x + attend(layers.rmsnorm(bp.pre_attn_norm, x))
    h = layers.rmsnorm(bp.pre_cross_norm, x)
    x = x + attention.apply_cross(bp.cross, acfg, h, enc_k, enc_v)
    h = layers.rmsnorm(bp.pre_mlp_norm, x)
    return x + layers.mlp(bp.mlp, h)


def apply_train(model: EncDecLM, cfg: ModelConfig, tokens: torch.Tensor,
                frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward: tokens (B, S_dec), frames (B, S_enc, d) →
    (logits (B, S_dec, vocab) fp32, aux_loss = 0). The decoder blocks are
    checkpointed as ``cfg.remat`` says (the encoder is not, as in the
    reference)."""
    enc = encode(model, cfg, frames)
    x = layers.embed(model.embed, tokens)
    rope = layers.rope_frequencies(cfg.head_dim, x.shape[1], cfg.rope_theta,
                                   device=x.device)
    acfg = cfg.attn_cfg

    def block(x, bp):
        ek, ev = attention.project_kv(bp.cross, acfg, enc)
        return _decoder_block(bp, acfg, x, lambda h: attention.apply_train(
            bp.attn, acfg, h, rope=rope), ek, ev)

    for bp in model.decoder:
        x = maybe_remat(lambda x, bp=bp: block(x, bp), cfg.remat)(x)
    return _logits(cfg, model, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


def init_caches(model: EncDecLM, cfg: ModelConfig, frames: torch.Tensor,
                max_s: int, dtype=torch.bfloat16) -> EncDecCaches:
    """Run the encoder once, store each decoder layer's cross K/V in
    ``dtype``, and allocate zeroed self-attention KV caches of ``max_s``
    positions with decode's P·V·Wo association planned for them
    (:func:`~repro_torch.models.transformer.plan_kv`, one consult)."""
    enc = encode(model, cfg, frames)
    acfg = cfg.attn_cfg
    cross = [attention.project_kv(bp.cross, acfg, enc) for bp in model.decoder]
    shape = (cfg.n_layers, frames.shape[0], max_s, cfg.n_kv_heads,
             cfg.head_dim)
    self_kv = KVCache(k=torch.zeros(shape, dtype=dtype, device=enc.device),
                      v=torch.zeros(shape, dtype=dtype, device=enc.device),
                      length=attention.new_length(enc.device))
    return EncDecCaches(
        self_kv=plan_kv(cfg, self_kv),
        cross_k=torch.stack([k for k, _ in cross]).to(dtype),
        cross_v=torch.stack([v for _, v in cross]).to(dtype))


def apply_decode(model: EncDecLM, cfg: ModelConfig, tokens: torch.Tensor,
                 caches: EncDecCaches) -> Tuple[torch.Tensor, EncDecCaches]:
    """One-token decode: tokens (B, 1) → (logits (B, 1, V), ``caches``,
    the same object, with the new self K/V written and the length
    advanced, in place; the cross K/V are fixed for the request). The
    RoPE table spans the self cache's capacity, as in the reference."""
    x = layers.embed(model.embed, tokens)
    kv = caches.self_kv
    rope = layers.rope_frequencies(cfg.head_dim, kv.k.shape[2],
                                   cfg.rope_theta, device=x.device)
    acfg = cfg.attn_cfg
    for i, bp in enumerate(model.decoder):
        cache = kv._replace(k=kv.k[i], v=kv.v[i])
        x = _decoder_block(
            bp, acfg, x, lambda h, bp=bp, cache=cache: attention.apply_decode(
                bp.attn, acfg, h, cache, rope=rope)[0],
            caches.cross_k[i].to(x.dtype), caches.cross_v[i].to(x.dtype))
    kv.length.add_(1)
    return _logits(cfg, model, x), caches
