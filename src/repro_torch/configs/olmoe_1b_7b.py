"""olmoe-1b-7b [moe] — arXiv:2409.02060.

16L, d_model 2048, 16H (kv=16), vocab 50304; every MLP is a 64-expert
top-8 MoE with expert d_ff 1024.
"""

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1024,
        vocab=50304,
        activation="silu",
        tied_embeddings=False,
        moe=MoEConfig(d_model=2048, d_ff=1024, n_experts=64, top_k=8),
        dense_residual=False,
        max_seq=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=64,
        vocab=256,
        activation="silu",
        tied_embeddings=False,
        moe=MoEConfig(d_model=64, d_ff=64, n_experts=4, top_k=2),
        dense_residual=False,
        max_seq=256,
    )
