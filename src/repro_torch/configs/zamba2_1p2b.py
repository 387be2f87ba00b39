"""zamba2-1.2b [hybrid] — arXiv:2411.15242.

38 Mamba2 layers (d_model 2048, ssm_state 64) with a single *shared*
attention+MLP block (32H kv=32, d_ff 8192) applied every 6 Mamba2 layers.

``config()`` and ``smoke()`` are the JAX package's presets: their shared
block is the reference's (``shared_block="reference"``), which reads the
hidden state alone as 32 heads of 64, has no adapters and uses
sliding-window attention (4096) so the long_500k decode cell stays
sub-quadratic with a ring-buffer KV cache. ``published()`` and
``published_smoke()`` (the ``zamba2_1p2b_published`` preset) compute
Zamba2's published block (``models.hybrid``): [hidden, embedding] in,
4,096 wide, as 32 heads of 128, the exact GELU, rank-128 adapters on q,
k, v and the MLP's gate_up, a ``linear`` a application, no window.
"""

import dataclasses

from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab=32000,
        activation="silu",
        tied_embeddings=True,
        ssm=SSMConfig(
            d_model=2048, d_inner=4096, n_heads=64, head_dim=64,
            n_groups=1, d_state=64, conv_kernel=4, chunk=128,
            ssd_mode="auto", discriminant="perfmodel",
        ),
        attn_every=6,
        shared_attn=True,
        shared_window=4096,
        max_seq=1048576,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=256,
        activation="silu",
        tied_embeddings=True,
        ssm=SSMConfig(
            d_model=64, d_inner=128, n_heads=4, head_dim=32,
            n_groups=1, d_state=16, conv_kernel=4, chunk=32,
            ssd_mode="auto", discriminant="perfmodel",
        ),
        attn_every=2,
        shared_attn=True,
        shared_window=32,
        max_seq=256,
    )


def _published(cfg: ModelConfig, adapter_rank: int) -> ModelConfig:
    return dataclasses.replace(
        cfg, name=cfg.name + "-published", shared_block="published",
        head_dim=2 * cfg.d_model // cfg.n_heads, activation="gelu_exact",
        adapter_rank=adapter_rank, attn_adapters=True, shared_window=0)


def published() -> ModelConfig:
    """Zamba2-1.2B with its published shared block, at the preset's
    widths (the SSD chunk stays the preset's)."""
    return _published(config(), 128)


def published_smoke() -> ModelConfig:
    """The smoke preset with the published block: 5 layers, so that the
    block is applied twice (before layers 2 and 4), adapters of rank 8."""
    return _published(dataclasses.replace(smoke(), n_layers=5), 8)
