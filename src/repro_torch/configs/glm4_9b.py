"""glm4-9b [dense] — hf:THUDM/glm-4-9b.

40L, d_model 4096, 32H (GQA kv=2), d_ff 13696, vocab 151552, RoPE, SwiGLU.
"""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab=151552,
        activation="silu",
        rope_theta=10000.0,
        tied_embeddings=False,
        max_seq=131072,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=256,
        activation="silu",
        tied_embeddings=False,
        max_seq=256,
    )
