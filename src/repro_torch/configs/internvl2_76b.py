"""internvl2-76b [vlm] — InternViT + LLaMA3-70B-family LM, arXiv:2404.16821.

LM backbone: 80L, d_model 8192, 64H (GQA kv=8), d_ff 28672, vocab 128256.
The InternViT vision frontend is a STUB per the assignment: input_specs
provides precomputed patch embeddings (vision_tokens × d_model) prepended
to the token embeddings.
"""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab=128256,
        activation="silu",
        rope_theta=500000.0,
        tied_embeddings=False,
        vision_tokens=256,
        max_seq=131072,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=256,
        activation="silu",
        tied_embeddings=False,
        vision_tokens=8,
        max_seq=256,
    )
