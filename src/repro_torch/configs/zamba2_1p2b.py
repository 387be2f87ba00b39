"""zamba2-1.2b [hybrid] — arXiv:2411.15242.

38 Mamba2 layers (d_model 2048, ssm_state 64) with a single *shared*
attention+MLP block (32H kv=32, d_ff 8192) applied every 6 Mamba2 layers.
The shared block uses sliding-window attention (4096) so the long_500k
decode cell stays sub-quadratic with a ring-buffer KV cache.
"""

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
