"""whisper-tiny [audio] — enc-dec, arXiv:2212.04356.

4L decoder (+4L encoder), d_model 384, 6 heads (kv=6), d_ff 1536,
vocab 51865. Conv/log-mel frontend is a STUB per the assignment:
input_specs provides the 1500 precomputed frame embeddings.
"""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="encdec",
        n_layers=4,
        encoder_layers=4,
        encoder_seq=1500,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab=51865,
        activation="gelu",       # plain MLP, not GLU
        tied_embeddings=True,
        max_seq=448,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke",
        family="encdec",
        n_layers=2,
        encoder_layers=2,
        encoder_seq=64,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=256,
        activation="gelu",
        tied_embeddings=True,
        max_seq=64,
    )
