"""Hybrid Mamba2 + shared-attention assembly (zamba2 family).

Counterpart of the reference's ``models/hybrid.py``. Zamba2 interleaves
Mamba2 blocks with a *shared* transformer block whose parameters are
reused at every application point (arXiv:2411.15242): ``n_layers``
Mamba2 blocks and, after every ``attn_every`` of them, the single shared
attention+MLP block, with sliding-window attention whose decode cache is
a ring buffer of ``shared_window`` slots.

As in the reference, zamba2's concatenated [hidden, embedding] input to
the shared block and its per-application LoRA deltas are omitted. There
is no prefill: ``serve.decode.generate`` feeds the prompt token by token.
Caches are updated in place, as the port's other caches are, and a
decode step reads its position only on the device (the RoPE row, the
ring slot and its mask are arithmetic on the cache's length tensor), so
it can be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.sharding.context import shard_seq

from . import attention, layers, ssm as ssm_lib
from .attention import KVCache
from .ssm import SSMCache
from .transformer import (ModelConfig, SSMBlock, _logits,
                          _ssm_block_apply, maybe_remat)


class HybridCaches(NamedTuple):
    ssm: SSMCache            # stacked (L, ...)
    shared_kv: KVCache       # stacked (n_attn, B, window, Hkv, Dh)


def n_shared_applications(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


class SharedBlock(nn.Module):
    """The single shared attention + GLU MLP block."""

    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        norm = dict(device=device, dtype=dtype)
        self.pre_attn_norm = layers.RMSNorm(cfg.d_model, **norm)
        self.attn = attention.Attention(cfg.attn_cfg, **kw)
        self.pre_mlp_norm = layers.RMSNorm(cfg.d_model, **norm)
        self.mlp = layers.GluMLP(cfg.d_model, cfg.d_ff, **kw)


class HybridLM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = layers.Embed(cfg.padded_vocab, cfg.d_model, **kw)
        self.blocks = nn.ModuleList(
            SSMBlock(cfg, **kw) for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, **kw)
        self.final_norm = layers.RMSNorm(cfg.d_model, device=device,
                                         dtype=dtype)


def init(cfg: ModelConfig, generator: Optional[torch.Generator], *,
         device, dtype=torch.float32) -> HybridLM:
    """Weights from the reference's distributions, drawn from
    ``generator`` (which lies on ``device``; ``None`` only for ``meta``)."""
    if cfg.family != "hybrid" or cfg.ssm is None:
        raise ValueError(f"{cfg.name}: hybrid.init takes the hybrid family "
                         f"with an SSM config, not {cfg.family}")
    return HybridLM(cfg, generator=generator, device=device, dtype=dtype)


def _groups(cfg: ModelConfig):
    """Layer ranges: ``n_groups`` groups of ``attn_every`` Mamba2 blocks,
    each followed by the shared block, then the remaining blocks."""
    k = cfg.attn_every or cfg.n_layers
    n_groups = cfg.n_layers // k
    groups = [range(g * k, (g + 1) * k) for g in range(n_groups)]
    return groups, range(n_groups * k, cfg.n_layers)


def _shared_block_train(cfg: ModelConfig, sp: SharedBlock, x: torch.Tensor,
                        rope) -> torch.Tensor:
    acfg = cfg.attn_cfg._replace(window=cfg.shared_window)
    h = layers.rmsnorm(sp.pre_attn_norm, x)
    x = x + attention.apply_train(sp.attn, acfg, h, rope=rope)
    h = layers.rmsnorm(sp.pre_mlp_norm, x)
    return shard_seq(x + layers.glu_mlp(sp.mlp, h))


def apply_train(model: HybridLM, cfg: ModelConfig, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, vocab) fp32, aux_loss = 0). The
    Mamba2 blocks are checkpointed as ``cfg.remat`` says (the shared block
    is not, as in the reference); the shared block's attention takes the
    differentiable route, :func:`~repro_torch.models.attention.
    chunked_attention` from ``CHUNKED_THRESHOLD`` positions on."""
    x = layers.embed(model.embed, tokens)
    s = x.shape[1]
    rope = layers.rope_frequencies(cfg.head_dim, s, cfg.rope_theta,
                                   device=x.device)

    def mamba(x, i):
        bp = model.blocks[i]
        return maybe_remat(lambda x: _ssm_block_apply(
            cfg, bp, x, lambda h: ssm_lib.apply_train(bp.mixer, cfg.ssm, h)),
            cfg.remat)(x)

    groups, rest = _groups(cfg)
    for group in groups:
        for i in group:
            x = mamba(x, i)
        x = _shared_block_train(cfg, model.shared, x, rope)
    for i in rest:
        x = mamba(x, i)
    return _logits(cfg, model, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


def init_caches(cfg: ModelConfig, batch: int, max_s: int,
                dtype=torch.bfloat16, device=None) -> HybridCaches:
    """Zeroed SSM caches for every layer and, for each application of the
    shared block, a windowed KV cache: a ring buffer of
    min(``shared_window``, ``max_s``) slots."""
    ssm = ssm_lib.init_cache(cfg.ssm, batch, dtype, device=device,
                             n_layers=cfg.n_layers)
    na = max(1, n_shared_applications(cfg))
    eff = min(cfg.shared_window or max_s, max_s)
    shape = (na, batch, eff, cfg.n_kv_heads, cfg.head_dim)
    kv = KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                 v=torch.zeros(shape, dtype=dtype, device=device),
                 length=attention.new_length(device))
    return HybridCaches(ssm=ssm, shared_kv=kv)


def _rope_at(cfg: ModelConfig, position: torch.Tensor):
    """Row ``position`` (a 0-d integer tensor) of the reference's
    ``rope_frequencies(head_dim, max_seq, theta)`` tables, computed alone
    on ``position``'s device (the same float32 products): decode reads
    one position, and the full tables would be ~268 MB a step at
    zamba2's 1,048,576 positions."""
    dh = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, dh, 2, dtype=torch.float32, device=position.device) / dh))
    ang = position.to(torch.float32).reshape(1, 1) * inv
    return torch.cos(ang), torch.sin(ang)


def _shared_block_decode(cfg: ModelConfig, sp: SharedBlock, x: torch.Tensor,
                         kv: KVCache, rope) -> Tuple[torch.Tensor, KVCache]:
    """Decode through the shared block with a ring-buffer window cache.
    ``rope`` holds the one row of the tables at ``kv.length``.

    As in the reference, the new K/V are written at slot length % size
    (an ``index_copy_`` at a device index), q is rounded to the cache's
    dtype before the logits (accumulated in float32), and the
    probabilities are rounded to it before P·V. The length is left to
    :func:`apply_decode`, which advances it once for every application."""
    acfg = cfg.attn_cfg._replace(window=cfg.shared_window)
    h = layers.rmsnorm(sp.pre_attn_norm, x)
    b = h.shape[0]
    length = kv.length
    pos = torch.zeros((b, 1), dtype=torch.long, device=x.device)
    q, k, v = attention._project_qkv(sp.attn, acfg, h, pos, rope)
    size = kv.k.shape[1]
    slot = length % size
    kv.k.index_copy_(1, slot.view(1), k.to(kv.k.dtype))
    kv.v.index_copy_(1, slot.view(1), v.to(kv.v.dtype))
    hkv = acfg.n_kv_heads
    group = acfg.n_heads // hkv
    scale = acfg.head_dim ** -0.5
    qg = attention._whole_parts(q, 2, hkv).to(kv.k.dtype).float() \
        .reshape(b, hkv, group, acfg.head_dim)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, kv.k.float()) * scale
    # Ring-buffer positions: slot s holds absolute position
    # length - ((slot - s) mod size); valid if within [0, length].
    slots = torch.arange(size, device=x.device)
    age = (slot - slots) % size
    abs_pos = length - age
    valid = (abs_pos >= 0) & (abs_pos <= length)
    if cfg.shared_window:
        valid &= age < cfg.shared_window
    logits = logits.masked_fill(~valid, -1e30)
    pattn = torch.softmax(logits, dim=-1).to(kv.v.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", pattn, kv.v)
    out = out.reshape(b, 1, acfg.n_heads * acfg.head_dim)
    x = x + layers.dense(sp.attn.wo, out.to(x.dtype))
    h = layers.rmsnorm(sp.pre_mlp_norm, x)
    x = x + layers.glu_mlp(sp.mlp, h)
    return x, kv


def apply_decode(model: HybridLM, cfg: ModelConfig, tokens: torch.Tensor,
                 caches: HybridCaches) -> Tuple[torch.Tensor, HybridCaches]:
    """One-token decode: tokens (B, 1) → (logits (B, 1, V), ``caches``,
    the same object, with the SSM tails and states and the shared K/V
    written and both lengths advanced, in place)."""
    x = layers.embed(model.embed, tokens)
    skv = caches.shared_kv
    rope = _rope_at(cfg, skv.length)

    def mamba(x, i):
        bp = model.blocks[i]
        sc = caches.ssm._replace(conv=caches.ssm.conv[i],
                                 state=caches.ssm.state[i])
        return _ssm_block_apply(cfg, bp, x, lambda h: ssm_lib.apply_decode(
            bp.mixer, cfg.ssm, h, sc)[0])

    groups, rest = _groups(cfg)
    for gi, group in enumerate(groups):
        for i in group:
            x = mamba(x, i)
        kv = skv._replace(k=skv.k[gi], v=skv.v[gi])
        x, _ = _shared_block_decode(cfg, model.shared, x, kv, rope)
    for i in rest:
        x = mamba(x, i)
    caches.ssm.length.add_(1)
    skv.length.add_(1)
    return _logits(cfg, model, x), caches
