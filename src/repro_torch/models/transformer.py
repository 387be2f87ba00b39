"""Decoder-LM assembly for the dense family.

Counterpart of the reference's ``models/transformer.py``, dense family
only (the MoE, SSM and hybrid branches wait for ROADMAP A7). ``init``
builds an ``nn.Module`` tree whose state-dict keys are the reference's
parameter paths; ``apply_train`` / ``apply_prefill`` / ``apply_decode``
run it. The reference's ``lax.scan`` over stacked layers becomes a
Python loop over ``blocks``: layer ``i`` takes window
``layer_windows()[i]``, the order in which the reference's gemma2
grouping walks its local/global pairs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from . import attention, layers
from .attention import AttnConfig, KVCache


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense (the only family ported)
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
    max_seq: int = 131072

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

    def layer_windows(self) -> Tuple[int, ...]:
        if not self.window_pattern:
            return (0,) * self.n_layers
        pat = list(self.window_pattern)
        reps = (self.n_layers + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[: self.n_layers])

    def param_count(self) -> int:
        """Parameters of a dense decoder (embedding + blocks)."""
        d = self.d_model
        n = self.vocab * d * (1 if self.tied_embeddings else 2)
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
            + self.n_heads * self.head_dim * d
        gates = 3 if self.activation_is_glu else 2
        return n + self.n_layers * (attn + gates * d * self.d_ff)

    @property
    def activation_is_glu(self) -> bool:
        return self.activation in ("silu", "gelu_glu")


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported to PyTorch "
            f"yet (ROADMAP A7)")


# ------------------------------------------------------------------ init ---

class Block(nn.Module):
    """One decoder block: pre-norms, attention, GLU (or plain) MLP and,
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
        mlp_cls = layers.GluMLP if cfg.activation_is_glu else layers.MLP
        self.mlp = mlp_cls(cfg.d_model, cfg.d_ff, **kw)


class DecoderLM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = layers.Embed(cfg.padded_vocab, cfg.d_model, **kw)
        self.blocks = nn.ModuleList(
            Block(cfg, **kw) for _ in range(cfg.n_layers))
        self.final_norm = layers.RMSNorm(cfg.d_model, device=device,
                                         dtype=dtype)
        if not cfg.tied_embeddings:
            self.lm_head = layers.Dense(cfg.d_model, cfg.padded_vocab, **kw)


def init(cfg: ModelConfig, generator: Optional[torch.Generator], *,
         device, dtype=torch.float32) -> DecoderLM:
    """Weights from the reference's distributions, drawn from
    ``generator`` (which lies on ``device``; ``None`` only for ``meta``)."""
    _check_dense(cfg)
    return DecoderLM(cfg, generator=generator, device=device, dtype=dtype)


# --------------------------------------------------------------- forward ---

def _block_apply(cfg: ModelConfig, bp: Block, x: torch.Tensor,
                 attend: Callable[[torch.Tensor], torch.Tensor]
                 ) -> torch.Tensor:
    """One block around ``attend`` (normed input → attention output)."""
    h = layers.rmsnorm(bp.pre_attn_norm, x, plus_one=cfg.norm_plus_one)
    attn_out = attend(h)
    if cfg.post_norms:
        attn_out = layers.rmsnorm(bp.post_attn_norm, attn_out,
                                  plus_one=cfg.norm_plus_one)
    x = x + attn_out
    h = layers.rmsnorm(bp.pre_mlp_norm, x, plus_one=cfg.norm_plus_one)
    if cfg.activation_is_glu:
        act = "silu" if cfg.activation == "silu" else "gelu"
        mlp_out = layers.glu_mlp(bp.mlp, h, act)
    else:
        mlp_out = layers.mlp(bp.mlp, h)
    if cfg.post_norms:
        mlp_out = layers.rmsnorm(bp.post_mlp_norm, mlp_out,
                                 plus_one=cfg.norm_plus_one)
    return x + mlp_out


def _embed(cfg: ModelConfig, model: DecoderLM,
           tokens: torch.Tensor) -> torch.Tensor:
    x = layers.embed(model.embed, tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _rope_tables(cfg: ModelConfig, max_pos: int, device):
    return layers.rope_frequencies(cfg.head_dim, max_pos, cfg.rope_theta,
                                   device=device)


def _logits(cfg: ModelConfig, model: DecoderLM,
            x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(model.final_norm, x, plus_one=cfg.norm_plus_one)
    if cfg.tied_embeddings:
        logits = x @ model.embed.w.to(x.dtype).T
    else:
        logits = layers.dense(model.lm_head, x)
    logits = layers.softcap(logits.float(), cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab:
        # pad columns carry no probability mass
        logits[..., cfg.vocab:] = -1e30
    return logits


def apply_train(model: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, vocab) fp32, aux_loss). Forward only:
    attention runs as the reference's differentiable route does (dense
    below the chunked threshold)."""
    _check_dense(cfg)
    x = _embed(cfg, model, tokens)
    s = x.shape[1]
    rope = _rope_tables(cfg, s, x.device)
    for bp, window in zip(model.blocks, cfg.layer_windows()):
        acfg = cfg.attn_cfg._replace(window=window)
        x = _block_apply(cfg, bp, x, lambda h, bp=bp, acfg=acfg:
                         attention.apply_train(bp.attn, acfg, h, rope=rope))
    return _logits(cfg, model, x), torch.zeros((), dtype=torch.float32)


# ------------------------------------------------------------- serving ---

class LayerCaches(NamedTuple):
    """Per-layer KV caches stacked on a leading layer axis:
    ``kv.k``/``kv.v`` (L, B, max_s, Hkv, Dh), ``kv.length`` shared."""
    kv: KVCache


def init_caches(cfg: ModelConfig, batch: int, max_s: int,
                dtype=torch.bfloat16, device=None) -> LayerCaches:
    """Zeroed caches of ``max_s`` positions, with the decode attention
    tail's association planned for them (:func:`plan_decode`)."""
    _check_dense(cfg)
    shape = (cfg.n_layers, batch, max_s, cfg.n_kv_heads, cfg.head_dim)
    return plan_decode(cfg, LayerCaches(kv=KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device), length=0)))


def plan_decode(cfg: ModelConfig, caches: LayerCaches) -> LayerCaches:
    """``caches`` with decode's P·V·Wo association resolved: one consult
    of the serving plan cache at the caches' capacity
    (:func:`~repro_torch.models.attention.planned_pv_right_first`; the
    ``REPRO_SERVE_PLANNER=0`` kill-switch, or a failure, gives left),
    carried by every decode step of these caches."""
    kv = caches.kv
    right = attention.planned_pv_right_first(
        1, kv.k.shape[2], cfg.head_dim, cfg.d_model, device=kv.k.device)
    return caches._replace(kv=kv._replace(right_first=right))


def _layer_cache(caches: LayerCaches, i: int) -> KVCache:
    kv = caches.kv
    return kv._replace(k=kv.k[i], v=kv.v[i])


def apply_prefill(model: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor,
                  caches: LayerCaches
                  ) -> Tuple[torch.Tensor, LayerCaches]:
    """Prefill: full-sequence forward that also fills the caches (in
    place). Attention takes the flash kernel when S is a multiple of 128
    and at least 256."""
    _check_dense(cfg)
    x = _embed(cfg, model, tokens)
    s = x.shape[1]
    rope = _rope_tables(cfg, max(s, caches.kv.k.shape[2]), x.device)
    for i, (bp, window) in enumerate(zip(model.blocks, cfg.layer_windows())):
        acfg = cfg.attn_cfg._replace(window=window)
        cache = _layer_cache(caches, i)

        def attend(h, bp=bp, acfg=acfg, cache=cache):
            out, _ = attention.apply_prefill(bp.attn, acfg, h, cache,
                                             rope=rope)
            return out

        x = _block_apply(cfg, bp, x, attend)
    logits = _logits(cfg, model, x)
    return logits, LayerCaches(kv=caches.kv._replace(length=s))


def _decode_attn_dynwin(p: attention.Attention, acfg: AttnConfig,
                        h: torch.Tensor, kv: KVCache, rope,
                        w: int) -> Tuple[torch.Tensor, KVCache]:
    """Decode attention with the layer's window ``w`` (gemma2 alternates
    local and global layers; the reference carries ``w`` through its scan
    as data)."""
    return attention.apply_decode(p, acfg._replace(window=w), h, kv,
                                  rope=rope)


def apply_decode(model: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor,
                 caches: LayerCaches) -> Tuple[torch.Tensor, LayerCaches]:
    """One-token decode: tokens (B, 1) → (logits (B, 1, V), caches with
    the new K/V written in place and the length advanced)."""
    _check_dense(cfg)
    x = _embed(cfg, model, tokens)
    rope = _rope_tables(cfg, caches.kv.k.shape[2], x.device)
    acfg = cfg.attn_cfg
    for i, (bp, window) in enumerate(zip(model.blocks, cfg.layer_windows())):
        cache = _layer_cache(caches, i)
        x = _block_apply(cfg, bp, x, lambda h, bp=bp, cache=cache, w=window:
                         _decode_attn_dynwin(bp.attn, acfg, h, cache, rope,
                                             w)[0])
    logits = _logits(cfg, model, x)
    return logits, LayerCaches(
        kv=caches.kv._replace(length=caches.kv.length + 1))
