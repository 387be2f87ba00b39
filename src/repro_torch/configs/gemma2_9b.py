"""gemma2-9b [dense] — arXiv:2408.00118 (hf: google/gemma-2-9b).

42L, d_model 3584, 16H (GQA kv=8, head_dim 256), d_ff 14336,
vocab 256000. Gemma-2 specifics reproduced: alternating local(4096)/global
attention, attention logit softcap 50, final logit softcap 30, RMSNorm
(1+g) convention, pre+post norms, embedding scaled by sqrt(d), GeGLU.
"""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab=256000,
        activation="gelu_glu",
        window_pattern=(4096, 0),      # local, global alternating
        attn_softcap=50.0,
        final_softcap=30.0,
        post_norms=True,
        norm_plus_one=True,
        embed_scale=True,
        tied_embeddings=True,
        max_seq=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=256,
        activation="gelu_glu",
        window_pattern=(32, 0),
        attn_softcap=50.0,
        final_softcap=30.0,
        post_norms=True,
        norm_plus_one=True,
        embed_scale=True,
        tied_embeddings=True,
        max_seq=256,
    )
