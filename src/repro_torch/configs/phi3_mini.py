"""phi3-mini-3.8b [dense] — arXiv:2404.14219.

32L, d_model 3072, 32H (kv=32, i.e. MHA), d_ff 8192, vocab 32064,
RoPE + SwiGLU. head_dim = 96, not a power of two: the flash-attention
kernel is instantiated for it.
"""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab=32064,
        activation="silu",
        tied_embeddings=True,
        max_seq=131072,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=256,
        activation="silu",
        tied_embeddings=True,
        max_seq=256,
    )
