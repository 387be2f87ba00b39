"""mamba2-370m [ssm] — SSD (state-space duality), arXiv:2405.21060.

48L, d_model 1024, attention-free, vocab 50280, ssm_state N=128.
Standard Mamba2 hyperparameters: expand=2 → d_inner 2048, head_dim 64
→ 32 SSD heads, 1 B/C group, conv kernel 4.

This arch is the strongest in-model application of the paper's technique:
the SSD layer's quadratic/chunked dual is selected per shape by the LAMP
discriminant (models/ssm.py::select_ssd_mode).
"""

from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        vocab=50280,
        tied_embeddings=True,
        ssm=SSMConfig(
            d_model=1024, d_inner=2048, n_heads=32, head_dim=64,
            n_groups=1, d_state=128, conv_kernel=4, chunk=128,
            ssd_mode="auto", discriminant="perfmodel",
        ),
        max_seq=1048576,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        vocab=256,
        tied_embeddings=True,
        ssm=SSMConfig(
            d_model=64, d_inner=128, n_heads=4, head_dim=32,
            n_groups=1, d_state=16, conv_kernel=4, chunk=32,
            ssd_mode="auto", discriminant="perfmodel",
        ),
        max_seq=512,
    )
