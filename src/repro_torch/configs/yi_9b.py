"""yi-9b [dense] — arXiv:2403.04652 (llama-architecture GQA).

48L, d_model 4096, 32H (GQA kv=4), d_ff 11008, vocab 64000.
"""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab=64000,
        activation="silu",
        rope_theta=5000000.0,
        tied_embeddings=False,
        max_seq=131072,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-9b-smoke",
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
