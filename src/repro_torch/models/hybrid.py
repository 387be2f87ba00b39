"""Hybrid Mamba2 + shared-attention assembly (zamba2 family).

Zamba2 interleaves Mamba2 blocks with a *shared* transformer block whose
parameters are reused at every application point (arXiv:2411.15242).
``ModelConfig.shared_block`` picks which block this module computes:

* ``"reference"`` (the default, and every preset's) — the counterpart of
  the JAX package's ``models/hybrid.py``: ``n_layers`` Mamba2 blocks and,
  after every ``attn_every`` of them, the single shared attention + SiLU
  GLU block on the hidden state alone, added to the residual stream, with
  sliding-window attention whose decode cache is a ring buffer of
  ``shared_window`` slots. Zamba2's concatenated [hidden, embedding]
  input and its per-application adapters are omitted, as in the JAX
  package.
* ``"published"`` — Zamba2's own block (``transformers``'
  ``Zamba2HybridLayer``): before each Mamba2 layer i of
  ``hybrid_layer_ids``, application a runs memory block a mod
  ``num_mem_blocks`` on u = rmsnorm([x, x₀]) (x₀ the embedding output,
  2·d_model wide): attention from 2·d_model to ``n_heads`` heads of
  ``head_dim`` with RoPE and logits scaled by (head_dim / 2)^-½, back to
  d_model; ``pre_ff_norm`` on its output (no residual inside the block);
  the GLU MLP ``activation(gate) · up`` from one ``gate_up`` product.
  Application a has its own rank-``adapter_rank`` adapters (A then B, no
  bias) on the MLP's gate_up and, with ``attn_adapters``, on q, k and v,
  and its own ``linear`` (d_model → d_model), whose output t is added to
  the input of Mamba2 layer i before its pre-norm:
  x ← x + mamba_i(rmsnorm(x + t)). The block's weights are shared by the
  applications, so their gradient sums over them; an adapter or a
  ``linear`` gets its own application's. The decode cache holds every
  position (no ring unless ``shared_window`` is set).

There is no prefill: ``serve.decode.generate`` feeds the prompt token by
token. Caches are updated in place, as the port's other caches are, and a
decode step reads its position only on the device (the RoPE row, the
cache slot and its mask are arithmetic on the cache's length tensor), so
it can be captured in a CUDA graph. The published block's training path
marks device regions ``hybrid.shared`` ⊃ ``hybrid.shared.attn``,
``hybrid.shared.mlp`` (and their ``.bwd``) around every application and
counts ``hybrid.shared.applications`` (:mod:`repro_torch.runtime.spans`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.runtime import spans
from repro_torch.sharding.context import shard_seq

from . import attention, layers, ssm as ssm_lib
from .attention import KVCache
from .ssm import SSMCache
from .transformer import (ModelConfig, SSMBlock, _logits,
                          _ssm_block_apply, maybe_remat)


class HybridCaches(NamedTuple):
    ssm: SSMCache            # stacked (L, ...)
    shared_kv: KVCache       # stacked (n_attn, B, window, Hkv, Dh)


def published(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` computes Zamba2's published shared block."""
    return cfg.shared_block == "published"


def n_shared_applications(cfg: ModelConfig) -> int:
    if published(cfg):
        return len(cfg.hybrid_layer_ids)
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


class Adapter(nn.Module):
    """A rank-r adapter x ↦ (x·A)·B with no bias: ``a`` ~ N(0, 1/d_in),
    ``b`` ~ N(0, 0.02²)."""

    def __init__(self, d_in: int, rank: int, d_out: int, axes, *,
                 generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.a = layers.Dense(d_in, rank, (axes[0], "lora"), **kw)
        self.b = layers.Dense(rank, d_out, ("lora", axes[1]), scale=0.02,
                              **kw)


def adapter(p: Adapter, x: torch.Tensor) -> torch.Tensor:
    return layers.dense(p.b, layers.dense(p.a, x))


class MemBlock(nn.Module):
    """One published shared block: ``input_norm`` (2·d_model), ``attn``
    (:meth:`ModelConfig.shared_attn_cfg`), ``pre_ff_norm`` and the GLU
    MLP's ``gate_up`` (d_model → 2·d_ff, [gate, up]) and ``down``."""

    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        norm = dict(device=device, dtype=dtype)
        self.input_norm = layers.RMSNorm(2 * cfg.d_model, **norm)
        self.attn = attention.Attention(cfg.shared_attn_cfg, d_out=cfg.d_model,
                                        **kw)
        self.pre_ff_norm = layers.RMSNorm(cfg.d_model, **norm)
        self.gate_up = layers.Dense(cfg.d_model, 2 * cfg.d_ff,
                                    ("embed", "ffn"), **kw)
        self.down = layers.Dense(cfg.d_ff, cfg.d_model, ("ffn", "embed"),
                                 **kw)


class Application(nn.Module):
    """What one application of the published block owns: its adapters
    (``q``, ``k``, ``v`` with ``attn_adapters``; ``gate_up``) and its
    ``linear`` (d_model → d_model)."""

    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        acfg, r = cfg.shared_attn_cfg, cfg.adapter_rank
        if cfg.attn_adapters:
            hq = acfg.n_heads * acfg.head_dim
            hkv = acfg.n_kv_heads * acfg.head_dim
            self.q = Adapter(acfg.d_model, r, hq, ("embed", "heads"), **kw)
            self.k = Adapter(acfg.d_model, r, hkv, ("embed", "kv_heads"),
                             **kw)
            self.v = Adapter(acfg.d_model, r, hkv, ("embed", "kv_heads"),
                             **kw)
        self.gate_up = Adapter(cfg.d_model, r, 2 * cfg.d_ff,
                               ("embed", "ffn"), **kw)
        self.linear = layers.Dense(cfg.d_model, cfg.d_model,
                                   ("embed", "embed"), **kw)


class HybridLM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = layers.Embed(cfg.padded_vocab, cfg.d_model, **kw)
        self.blocks = nn.ModuleList(
            SSMBlock(cfg, **kw) for _ in range(cfg.n_layers))
        if published(cfg):
            self.mem_blocks = nn.ModuleList(
                MemBlock(cfg, **kw) for _ in range(cfg.num_mem_blocks))
            self.applications = nn.ModuleList(
                Application(cfg, **kw)
                for _ in range(n_shared_applications(cfg)))
        else:
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
    if cfg.shared_block not in ("reference", "published"):
        raise ValueError(f"{cfg.name}: shared_block must be reference or "
                         f"published, not {cfg.shared_block!r}")
    ids = cfg.hybrid_layer_ids
    if published(cfg) and (cfg.adapter_rank < 1 or cfg.num_mem_blocks < 1
                           or not ids or not 0 <= min(ids) <= max(ids)
                           < cfg.n_layers):
        raise ValueError(f"{cfg.name}: the published shared block needs an "
                         f"adapter_rank and num_mem_blocks of at least 1 "
                         f"and hybrid layers among the {cfg.n_layers}, not "
                         f"{ids}")
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


def _mamba_train(cfg: ModelConfig, bp: SSMBlock, x: torch.Tensor,
                 t: Optional[torch.Tensor]) -> torch.Tensor:
    """x + mamba(rmsnorm(x + t)): a Mamba2 block whose normed input takes
    the published block's output ``t`` (None: none) and whose residual
    does not."""
    h = layers.rmsnorm(bp.pre_norm, x if t is None else x + t)
    return shard_seq(x + ssm_lib.apply_train(bp.mixer, cfg.ssm, h))


def _qkv_deltas(ap: Application, u: torch.Tensor):
    if not hasattr(ap, "q"):
        return None
    return adapter(ap.q, u), adapter(ap.k, u), adapter(ap.v, u)


def _published_mlp(cfg: ModelConfig, mb: MemBlock, ap: Application,
                   o: torch.Tensor) -> torch.Tensor:
    """W_down(act(gate) · up) of rmsnorm(o), [gate, up] = W_gu·h plus the
    application's gate_up adapter."""
    h = layers.rmsnorm(mb.pre_ff_norm, o)
    gate, up = (layers.dense(mb.gate_up, h)
                + adapter(ap.gate_up, h)).chunk(2, dim=-1)
    return layers.dense(mb.down, layers.ACTIVATIONS[cfg.activation](gate)
                        * up)


def _published_block_train(cfg: ModelConfig, mb: MemBlock, ap: Application,
                           x: torch.Tensor, x0: torch.Tensor,
                           rope) -> torch.Tensor:
    """One application of the published block → t (B, S, d_model)."""
    spans.count("hybrid.shared.applications")
    x, x0 = spans.region("hybrid.shared", x, x0)
    u = layers.rmsnorm(mb.input_norm, torch.cat([x, x0], dim=-1))
    u = spans.region("hybrid.shared.attn", u)
    o = spans.region_end("hybrid.shared.attn", attention.apply_train(
        mb.attn, cfg.shared_attn_cfg, u, rope=rope,
        deltas=_qkv_deltas(ap, u)))
    o = spans.region("hybrid.shared.mlp", o)
    m = spans.region_end("hybrid.shared.mlp",
                         _published_mlp(cfg, mb, ap, o))
    return spans.region_end("hybrid.shared", layers.dense(ap.linear, m))


def _published_train(model: HybridLM, cfg: ModelConfig,
                     tokens: torch.Tensor) -> torch.Tensor:
    """The published layout's hidden states before the final norm."""
    x0 = layers.embed(model.embed, tokens)
    rope = layers.rope_frequencies(cfg.head_dim, x0.shape[1],
                                   cfg.rope_theta, device=x0.device)
    app = {layer: a for a, layer in enumerate(cfg.hybrid_layer_ids)}
    x = x0
    for i, bp in enumerate(model.blocks):
        t = None
        if i in app:
            a = app[i]
            t = _published_block_train(
                cfg, model.mem_blocks[a % cfg.num_mem_blocks],
                model.applications[a], x, x0, rope)
        x = maybe_remat(lambda x, t, bp=bp: _mamba_train(cfg, bp, x, t),
                        cfg.remat)(x, t)
    return x


def apply_train(model: HybridLM, cfg: ModelConfig, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, vocab) fp32, aux_loss = 0). The
    Mamba2 blocks are checkpointed as ``cfg.remat`` says (the shared block
    is not, as in the reference); the shared block's attention takes the
    differentiable route, :func:`~repro_torch.models.attention.
    chunked_attention` from ``CHUNKED_THRESHOLD`` positions on."""
    if published(cfg):
        x = _published_train(model, cfg, tokens)
        return _logits(cfg, model, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)
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
    shared block, a KV cache: the reference block's a ring buffer of
    min(``shared_window``, ``max_s``) slots, the published block's
    ``max_s`` positions."""
    ssm = ssm_lib.init_cache(cfg.ssm, batch, dtype, device=device,
                             n_layers=cfg.n_layers)
    na = max(1, n_shared_applications(cfg))
    eff = max_s if published(cfg) else min(cfg.shared_window or max_s,
                                           max_s)
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


def _published_decode(model: HybridLM, cfg: ModelConfig,
                      tokens: torch.Tensor,
                      caches: HybridCaches) -> torch.Tensor:
    """The published layout's decode step (the equations of
    :func:`_published_train` on one token, x₀ its own embedding, through
    each application's KV cache) → hidden states before the final norm."""
    x0 = layers.embed(model.embed, tokens)
    skv = caches.shared_kv
    rope = layers.rope_frequencies(cfg.head_dim, skv.k.shape[2],
                                   cfg.rope_theta, device=x0.device)
    acfg = cfg.shared_attn_cfg
    app = {layer: a for a, layer in enumerate(cfg.hybrid_layer_ids)}
    x = x0
    for i, bp in enumerate(model.blocks):
        h = x
        if i in app:
            a = app[i]
            mb, ap = model.mem_blocks[a % cfg.num_mem_blocks], \
                model.applications[a]
            u = layers.rmsnorm(mb.input_norm, torch.cat([x, x0], dim=-1))
            o, _ = attention.apply_decode(
                mb.attn, acfg, u, skv._replace(k=skv.k[a], v=skv.v[a]),
                rope=rope, deltas=_qkv_deltas(ap, u))
            h = x + layers.dense(ap.linear, _published_mlp(cfg, mb, ap, o))
        sc = caches.ssm._replace(conv=caches.ssm.conv[i],
                                 state=caches.ssm.state[i])
        x = shard_seq(x + ssm_lib.apply_decode(
            bp.mixer, cfg.ssm, layers.rmsnorm(bp.pre_norm, h), sc)[0])
    return x


def apply_decode(model: HybridLM, cfg: ModelConfig, tokens: torch.Tensor,
                 caches: HybridCaches) -> Tuple[torch.Tensor, HybridCaches]:
    """One-token decode: tokens (B, 1) → (logits (B, 1, V), ``caches``,
    the same object, with the SSM tails and states and the shared K/V
    written and both lengths advanced, in place)."""
    if published(cfg):
        x = _published_decode(model, cfg, tokens, caches)
        caches.ssm.length.add_(1)
        caches.shared_kv.length.add_(1)
        return _logits(cfg, model, x), caches
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
