"""Decoder-LM assembly for the dense, MoE, SSM and vlm families.

Counterpart of the reference's ``models/transformer.py`` (the hybrid
family is :mod:`.hybrid`, the encdec family :mod:`.encdec`). The vlm
family is the decoder stack with a prefix: ``apply_train`` and
``apply_prefill`` take ``prefix_embeds`` (B, P, d), precomputed vision
embeddings placed before the token embeddings. ``init``
builds an ``nn.Module`` tree whose state-dict keys are the reference's
parameter paths; ``apply_train`` / ``apply_prefill`` / ``apply_decode``
run it. The reference's ``lax.scan`` over stacked layers (its
``scan_util.scan``) becomes a Python loop over ``blocks``: layer ``i``
takes window ``layer_windows()[i]``, the order in which the reference's
gemma2 grouping walks its local/global pairs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.sharding.context import (grad_in_layout, shard_logits,
                                          shard_seq, whole_within)

from . import attention, layers, moe as moe_lib, ssm as ssm_lib
from .attention import AttnConfig, KVCache
from .moe import MoEConfig
from .ssm import SSMCache, SSMConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    activation: str = "silu"
    rope_theta: float = 10000.0
    final_softcap: float = 0.0
    attn_softcap: float = 0.0
    window_pattern: Tuple[int, ...] = ()   # cycled per layer; 0 = global
    post_norms: bool = False
    norm_plus_one: bool = False
    embed_scale: bool = False
    tied_embeddings: bool = True
    # moe
    moe: Optional[MoEConfig] = None
    dense_residual: bool = False
    # ssm / hybrid
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0
    shared_attn: bool = False
    shared_window: int = 0
    # encdec
    encoder_layers: int = 0
    encoder_seq: int = 0
    # vlm: precomputed vision embeddings before the tokens
    vision_tokens: int = 0
    max_seq: int = 131072
    # activation rematerialization of the training path, per block:
    # none | dots | full (:func:`maybe_remat`)
    remat: str = "none"
    # hybrid: the shared block :mod:`.hybrid` computes. "reference" is the
    # JAX package's (the hidden state alone, no adapters); "published" is
    # Zamba2's ([hidden, embedding] in, ``num_mem_blocks`` blocks taken in
    # turn, a rank-``adapter_rank`` adapter on the MLP's gate_up of every
    # application and, with ``attn_adapters``, on its q, k and v) before
    # the Mamba2 layers of ``hybrid_layer_ids``
    shared_block: str = "reference"
    num_mem_blocks: int = 1
    adapter_rank: int = 0
    attn_adapters: bool = False
    hybrid_layers: Tuple[int, ...] = ()    # () = every attn_every-th

    def __post_init__(self):
        # a list set by dotted path (a benchmark's configuration file)
        # is kept as the tuple that a frozen config hashes
        object.__setattr__(self, "hybrid_layers", tuple(self.hybrid_layers))

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 when not divisible by 16
        (the reference pads so an LM head shards); lookups never touch the
        pad rows and ``_logits`` masks the pad columns."""
        if self.vocab % 16 == 0:
            return self.vocab
        return ((self.vocab + 127) // 128) * 128

    @property
    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            rope_theta=self.rope_theta, logit_softcap=self.attn_softcap,
        )

    @property
    def shared_attn_cfg(self) -> AttnConfig:
        """The published shared block's attention: [hidden, embedding] in
        (2·d_model; its output is d_model wide), logits scaled by
        (head_dim / 2)^-½, as Zamba2's, and a window of ``shared_window``
        (0: none)."""
        return self.attn_cfg._replace(
            d_model=2 * self.d_model, window=self.shared_window,
            query_pre_scale=(self.head_dim / 2) ** -0.5)

    @property
    def hybrid_layer_ids(self) -> list:
        """The Mamba2 layers whose input the published shared block's
        applications feed: ``hybrid_layers``, or where that is empty every
        ``attn_every``-th from ``attn_every`` on (``transformers``' default
        pattern)."""
        if self.hybrid_layers or not self.attn_every:
            return list(self.hybrid_layers)
        return list(range(self.attn_every, self.n_layers, self.attn_every))

    def layer_windows(self) -> Tuple[int, ...]:
        if not self.window_pattern:
            return (0,) * self.n_layers
        pat = list(self.window_pattern)
        reps = (self.n_layers + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[: self.n_layers])

    def param_count(self) -> int:
        """The reference's analytic parameter count: embedding, attention,
        MLP, MoE and SSM projections, the hybrid's shared block (the
        published one with its adapters and ``linear``s), and an encoder's
        blocks and the decoder's cross-attention (norm gains, the SSM conv
        and its per-head vectors left out)."""
        d = self.d_model
        n = self.vocab * d * (1 if self.tied_embeddings else 2)
        L = self.n_layers
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
            + self.n_heads * self.head_dim * d
        if self.family in ("dense", "moe", "encdec", "vlm"):
            n += L * attn
        if self.family in ("dense", "encdec", "vlm"):
            gates = 3 if self.activation_is_glu else 2
            n += L * gates * d * self.d_ff
        if self.moe is not None:
            n += L * (d * self.moe.n_experts
                      + 3 * self.moe.n_experts * d * self.moe.d_ff)
            if self.dense_residual:
                n += L * 3 * d * self.d_ff
        if self.ssm is not None:
            s = self.ssm
            proj = 2 * s.d_inner + 2 * s.n_groups * s.d_state + s.n_heads
            # every hybrid layer is an SSM layer; the shared block below
            n += L * (d * proj + s.d_inner * d)
        if self.shared_attn and self.shared_block == "published":
            n += self._published_shared_count()
        elif self.shared_attn:
            n += attn + 3 * d * self.d_ff
        if self.encoder_layers:
            # the encoder's blocks (plain 2-matrix MLP), then the
            # decoder's cross-attention
            n += self.encoder_layers * (attn + 2 * d * self.d_ff)
            n += L * attn
        return n

    def _published_shared_count(self) -> int:
        """The published shared blocks (attention from 2·d_model, the GLU
        MLP's gate_up and down) and each application's adapters and
        ``linear``."""
        d, r = self.d_model, self.adapter_rank
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        block = 2 * d * (hq + 2 * hkv) + hq * d + 3 * d * self.d_ff
        app = d * d + r * (d + 2 * self.d_ff)
        if self.attn_adapters:
            app += r * (2 * d + hq) + 2 * r * (2 * d + hkv)
        return self.num_mem_blocks * block + len(self.hybrid_layer_ids) * app

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        n = self.param_count()
        n -= self.n_layers * 3 * self.moe.n_experts * d * self.moe.d_ff
        n += self.n_layers * 3 * self.moe.top_k * d * self.moe.d_ff
        return n

    @property
    def activation_is_glu(self) -> bool:
        return self.activation in ("silu", "gelu_glu")


#: The families this module assembles (hybrid is :mod:`.hybrid`, encdec
#: :mod:`.encdec`; vlm is the decoder stack with a prefix).
FAMILIES = ("dense", "moe", "ssm", "vlm")
#: The families another module assembles.
_ASSEMBLED_ELSEWHERE = {"hybrid": "models.hybrid", "encdec": "models.encdec"}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in _ASSEMBLED_ELSEWHERE:
        raise ValueError(f"{cfg.name}: the {cfg.family} family is assembled "
                         f"by {_ASSEMBLED_ELSEWHERE[cfg.family]}")
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


# ------------------------------------------------------------------ init ---

class Block(nn.Module):
    """One attention block: pre-norms, attention, then a GLU (or plain)
    MLP, or a MoE (with a parallel GLU MLP when ``dense_residual``) and,
    for gemma2, post-norms."""

    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        norm = dict(device=device, dtype=dtype)
        self.pre_attn_norm = layers.RMSNorm(cfg.d_model, **norm)
        self.attn = attention.Attention(cfg.attn_cfg, **kw)
        self.pre_mlp_norm = layers.RMSNorm(cfg.d_model, **norm)
        if cfg.post_norms:
            self.post_attn_norm = layers.RMSNorm(cfg.d_model, **norm)
            self.post_mlp_norm = layers.RMSNorm(cfg.d_model, **norm)
        if cfg.moe is not None:
            self.moe = moe_lib.MoE(cfg.moe, **kw)
            if cfg.dense_residual:
                self.mlp = layers.GluMLP(cfg.d_model, cfg.d_ff, **kw)
        else:
            mlp_cls = layers.GluMLP if cfg.activation_is_glu else layers.MLP
            self.mlp = mlp_cls(cfg.d_model, cfg.d_ff, **kw)


class SSMBlock(nn.Module):
    """One Mamba2 block: ``pre_norm`` and the ``mixer``."""

    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        self.pre_norm = layers.RMSNorm(cfg.d_model, device=device,
                                       dtype=dtype)
        self.mixer = ssm_lib.Mamba2Mixer(cfg.ssm, generator=generator,
                                         device=device, dtype=dtype)


class DecoderLM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = layers.Embed(cfg.padded_vocab, cfg.d_model, **kw)
        block = SSMBlock if cfg.family == "ssm" else Block
        self.blocks = nn.ModuleList(
            block(cfg, **kw) for _ in range(cfg.n_layers))
        self.final_norm = layers.RMSNorm(cfg.d_model, device=device,
                                         dtype=dtype)
        if not cfg.tied_embeddings:
            self.lm_head = layers.Dense(cfg.d_model, cfg.padded_vocab,
                                        ("embed", "vocab"), **kw)


def init(cfg: ModelConfig, generator: Optional[torch.Generator], *,
         device, dtype=torch.float32) -> DecoderLM:
    """Weights from the reference's distributions, drawn from
    ``generator`` (which lies on ``device``; ``None`` only for ``meta``)."""
    _check_family(cfg)
    return DecoderLM(cfg, generator=generator, device=device, dtype=dtype)


# --------------------------------------------------------------- forward ---

def _block_apply(cfg: ModelConfig, bp: Block, x: torch.Tensor,
                 attend: Callable[[torch.Tensor], torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One attention block around ``attend`` (normed input → attention
    output) → (x, the MoE's aux loss, None without a MoE)."""
    h = layers.rmsnorm(bp.pre_attn_norm, x, plus_one=cfg.norm_plus_one)
    attn_out = attend(h)
    if cfg.post_norms:
        attn_out = layers.rmsnorm(bp.post_attn_norm, attn_out,
                                  plus_one=cfg.norm_plus_one)
    x = x + attn_out
    h = layers.rmsnorm(bp.pre_mlp_norm, x, plus_one=cfg.norm_plus_one)
    aux = None
    if cfg.moe is not None:
        mlp_out, aux = moe_lib.apply(bp.moe, cfg.moe, h)
        if cfg.dense_residual:
            mlp_out = mlp_out + layers.glu_mlp(bp.mlp, h, cfg.activation)
    elif cfg.activation_is_glu:
        act = "silu" if cfg.activation == "silu" else "gelu"
        mlp_out = layers.glu_mlp(bp.mlp, h, act)
    else:
        mlp_out = layers.mlp(bp.mlp, h)
    if cfg.post_norms:
        mlp_out = layers.rmsnorm(bp.post_mlp_norm, mlp_out,
                                 plus_one=cfg.norm_plus_one)
    return shard_seq(x + mlp_out), aux


def _ssm_block_apply(cfg: ModelConfig, bp: SSMBlock, x: torch.Tensor,
                     mix: Callable[[torch.Tensor], torch.Tensor]
                     ) -> torch.Tensor:
    """One Mamba2 block around ``mix`` (normed input → mixer output)."""
    h = layers.rmsnorm(bp.pre_norm, x, plus_one=cfg.norm_plus_one)
    return shard_seq(x + mix(h))


def _embed(cfg: ModelConfig, model: DecoderLM, tokens: torch.Tensor,
           prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (scaled where the config says so) after the
    ``prefix_embeds`` (B, P, d), cast to the activation dtype and never
    scaled: (B, P + S, d)."""
    x = layers.embed(model.embed, tokens)
    if cfg.embed_scale:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return shard_seq(x)


def _rope_tables(cfg: ModelConfig, max_pos: int, device):
    if cfg.family == "ssm":
        return None
    return layers.rope_frequencies(cfg.head_dim, max_pos, cfg.rope_theta,
                                   device=device)


def _logits(cfg: ModelConfig, model: DecoderLM,
            x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(model.final_norm, x, plus_one=cfg.norm_plus_one)
    if cfg.tied_embeddings:
        logits = grad_in_layout(
            whole_within(x, 0, 1) @ model.embed.w.to(x.dtype).T)
    else:
        logits = layers.dense(model.lm_head, x)
    logits = shard_logits(logits)
    logits = layers.softcap(logits.float(), cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab:
        # pad columns carry no probability mass; out of place, so that a
        # backward through the soft-cap's tanh (which saves its output)
        # still works
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


#: The matrix products that ``remat="dots"`` keeps: the ATen ops that
#: ``@``, ``einsum`` and ``F.linear`` dispatch to.
_DOTS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(fn: Callable, remat: str) -> Callable:
    """Per-block activation checkpointing of the training path, the
    reference's ``_maybe_remat``: ``none`` saves what autograd saves;
    ``full`` keeps only the block's inputs and runs the block again in the
    backward pass (``torch.utils.checkpoint``, non-reentrant); ``dots``
    approximates ``jax.checkpoint_policies.checkpoint_dots`` with
    selective checkpointing that saves the outputs of the matrix products
    (``mm``, ``bmm``, ``addmm``, ``baddbmm``) and recomputes every other
    op. Without autograd (serving) ``fn`` runs as it is."""
    if remat not in ("none", "dots", "full"):
        raise ValueError(f"remat must be none, dots or full, not {remat!r}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    if remat == "full":
        return lambda *args: ckpt.checkpoint(fn, *args, use_reentrant=False)
    context = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                _save_dots)
    return lambda *args: ckpt.checkpoint(fn, *args, use_reentrant=False,
                                         context_fn=context)


def apply_train(model: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, P + S, vocab) fp32, aux_loss summed
    over the MoE layers), P the length of ``prefix_embeds`` (B, P, d), 0
    without. Attention takes the differentiable route (dense below the
    chunked threshold, :func:`~repro_torch.models.attention.
    chunked_attention` from it on), the SSM layers ``ssm.ssd``'s
    selected algorithm; each block is checkpointed as ``cfg.remat``
    says."""
    _check_family(cfg)
    x = _embed(cfg, model, tokens, prefix_embeds)
    s = x.shape[1]
    rope = _rope_tables(cfg, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp, window in zip(model.blocks, cfg.layer_windows()):
        if cfg.family == "ssm":
            x = maybe_remat(lambda x, bp=bp: _ssm_block_apply(
                cfg, bp, x, lambda h: ssm_lib.apply_train(bp.mixer, cfg.ssm,
                                                          h)), cfg.remat)(x)
            continue
        acfg = cfg.attn_cfg._replace(window=window)
        x, a = maybe_remat(lambda x, bp=bp, acfg=acfg: _block_apply(
            cfg, bp, x, lambda h: attention.apply_train(bp.attn, acfg, h,
                                                        rope=rope)),
            cfg.remat)(x)
        if a is not None:
            aux = aux + a
    return _logits(cfg, model, x), aux


# ------------------------------------------------------------- serving ---

class LayerCaches(NamedTuple):
    """Per-layer caches stacked on a leading layer axis: attention
    families ``kv.k``/``kv.v`` (L, B, max_s, Hkv, Dh), the SSM family
    ``ssm.conv`` (L, B, K-1, C) and ``ssm.state`` (L, B, H, N, P); the
    length (a 0-d device tensor) is shared, and a step advances it once,
    in place."""
    kv: Optional[KVCache]
    ssm: Optional[SSMCache] = None


def init_caches(cfg: ModelConfig, batch: int, max_s: int,
                dtype=torch.bfloat16, device=None) -> LayerCaches:
    """Zeroed caches (KV caches of ``max_s`` positions, with the decode
    attention tail's association planned for them, :func:`plan_decode`;
    SSM caches of one conv tail and state a layer)."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return LayerCaches(kv=None, ssm=ssm_lib.init_cache(
            cfg.ssm, batch, dtype, device=device, n_layers=cfg.n_layers))
    shape = (cfg.n_layers, batch, max_s, cfg.n_kv_heads, cfg.head_dim)
    return plan_decode(cfg, LayerCaches(kv=KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=attention.new_length(device))))


def plan_decode(cfg: ModelConfig, caches: LayerCaches) -> LayerCaches:
    """``caches`` with decode's P·V·Wo association resolved
    (:func:`plan_kv`). Caches without attention (the SSM family) make no
    consult and are returned as they are."""
    if caches.kv is None:
        return caches
    return caches._replace(kv=plan_kv(cfg, caches.kv))


def plan_kv(cfg: ModelConfig, kv: KVCache) -> KVCache:
    """Stacked KV caches ``kv`` (L, B, max_s, Hkv, Dh) with decode's
    P·V·Wo association resolved: one consult of the serving plan cache at
    their capacity (:func:`~repro_torch.models.attention.
    planned_pv_right_first`; the ``REPRO_SERVE_PLANNER=0`` kill-switch,
    or a failure, gives left), carried by every decode step of them."""
    if kv.k.device.type == "meta":       # an abstract cache: no consult
        return kv
    right = attention.planned_pv_right_first(
        1, kv.k.shape[2], cfg.head_dim, cfg.d_model, device=kv.k.device)
    return kv._replace(right_first=right)


def _layer_cache(caches: LayerCaches, i: int) -> KVCache:
    kv = caches.kv
    return kv._replace(k=kv.k[i], v=kv.v[i])


def _layer_ssm_cache(caches: LayerCaches, i: int) -> SSMCache:
    sc = caches.ssm
    return sc._replace(conv=sc.conv[i], state=sc.state[i])


def apply_prefill(model: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor,
                  caches: LayerCaches,
                  prefix_embeds: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, LayerCaches]:
    """Prefill: full-sequence forward that also fills the caches (in
    place) → (logits (B, P + S, vocab), caches of length P + S), P the
    length of ``prefix_embeds``. Attention takes the flash kernel when
    P + S is a multiple of 128 and at least 256; the SSM family runs
    chunked SSD with the final state handed to the cache (S a multiple
    of min(chunk, S))."""
    _check_family(cfg)
    x = _embed(cfg, model, tokens, prefix_embeds)
    s = x.shape[1]
    if cfg.family == "ssm":
        for i, bp in enumerate(model.blocks):
            x = _ssm_block_apply(
                cfg, bp, x, lambda h, bp=bp, sc=_layer_ssm_cache(caches, i):
                ssm_lib.apply_prefill(bp.mixer, cfg.ssm, h, sc)[0])
        return _logits(cfg, model, x), caches
    rope = _rope_tables(cfg, max(s, caches.kv.k.shape[2]), x.device)
    for i, (bp, window) in enumerate(zip(model.blocks, cfg.layer_windows())):
        acfg = cfg.attn_cfg._replace(window=window)
        cache = _layer_cache(caches, i)

        def attend(h, bp=bp, acfg=acfg, cache=cache):
            out, _ = attention.apply_prefill(bp.attn, acfg, h, cache,
                                             rope=rope)
            return out

        x, _ = _block_apply(cfg, bp, x, attend)
    return _logits(cfg, model, x), caches


def _decode_attn_dynwin(p: attention.Attention, acfg: AttnConfig,
                        h: torch.Tensor, kv: KVCache, rope,
                        w: int) -> Tuple[torch.Tensor, KVCache]:
    """Decode attention with the layer's window ``w`` (gemma2 alternates
    local and global layers; the reference carries ``w`` through its scan
    as data), leaving the shared length to :func:`apply_decode`."""
    return attention.apply_decode(p, acfg._replace(window=w), h, kv,
                                  rope=rope)


def apply_decode(model: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor,
                 caches: LayerCaches) -> Tuple[torch.Tensor, LayerCaches]:
    """One-token decode: tokens (B, 1) → (logits (B, 1, V), ``caches``,
    the same object, with the new K/V (or SSM conv tail and state)
    written and the length advanced, all in place). The step reads no
    value on the host and builds no tensor from host data, so it can be
    captured in a CUDA graph and replayed (``serve.decode``); the RoPE
    tables are rebuilt inside it, on the device, for the cache's
    capacity."""
    _check_family(cfg)
    x = _embed(cfg, model, tokens)
    if cfg.family == "ssm":
        for i, bp in enumerate(model.blocks):
            x = _ssm_block_apply(
                cfg, bp, x, lambda h, bp=bp, sc=_layer_ssm_cache(caches, i):
                ssm_lib.apply_decode(bp.mixer, cfg.ssm, h, sc)[0])
        caches.ssm.length.add_(1)
        return _logits(cfg, model, x), caches
    rope = _rope_tables(cfg, caches.kv.k.shape[2], x.device)
    acfg = cfg.attn_cfg
    for i, (bp, window) in enumerate(zip(model.blocks, cfg.layer_windows())):
        cache = _layer_cache(caches, i)
        x, _ = _block_apply(cfg, bp, x, lambda h, bp=bp, cache=cache,
                            w=window: _decode_attn_dynwin(bp.attn, acfg, h,
                                                          cache, rope, w)[0])
    caches.kv.length.add_(1)
    return _logits(cfg, model, x), caches
