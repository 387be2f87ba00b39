"""arctic-480b [moe] — hf:Snowflake/snowflake-arctic-base.

35L, d_model 7168, 56H (GQA kv=8), vocab 32000. Dense-MoE hybrid
residual: every layer runs a dense SwiGLU MLP (d_ff 4864) in parallel with
a 128-expert top-2 MoE (expert d_ff 4864).
"""

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab=32000,
        activation="silu",
        tied_embeddings=False,
        moe=MoEConfig(d_model=7168, d_ff=4864, n_experts=128, top_k=2),
        dense_residual=True,
        max_seq=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab=256,
        activation="silu",
        tied_embeddings=False,
        moe=MoEConfig(d_model=64, d_ff=96, n_experts=4, top_k=2),
        dense_residual=True,
        max_seq=256,
    )
