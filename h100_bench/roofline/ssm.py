"""Parameters and forward FLOPs of the ``ssm`` family (Mamba2,
arXiv:2405.21060): the matrix products of every projection, the depthwise
convolution, the SSD in its chunked form (per token and head 2·Q·(N + P)
within the chunk and 4·N·P for the states) and the tied output head.
Elementwise work is left out.
"""

from __future__ import annotations


def param_count(cfg: dict) -> int:
    """Every parameter of the model as it is run (the padded embedding
    rows, norms, conv and per-head vectors included)."""
    d, s = cfg["d_model"], cfg["ssm"]
    gn = s["n_groups"] * s["d_state"]
    di, h, conv = s["d_inner"], s["n_heads"], s["d_inner"] + 2 * gn
    layer = (d * (2 * di + 2 * gn + h) + di * d + s["conv_kernel"] * conv
             + conv + 3 * h + di + d)
    return cfg["padded_vocab"] * d + cfg["n_layers"] * layer + d


def ssd_flops_per_token(cfg: dict) -> float:
    s = cfg["ssm"]
    q, n, p = s["chunk"], s["d_state"], s["head_dim"]
    return s["n_heads"] * (2 * q * (n + p) + 4 * n * p)


def matmul_flops_per_token(cfg: dict) -> float:
    d, s = cfg["d_model"], cfg["ssm"]
    gn = s["n_groups"] * s["d_state"]
    di = s["d_inner"]
    return (2 * d * (2 * di + 2 * gn + s["n_heads"]) + 2 * di * d
            + 2 * s["conv_kernel"] * (di + 2 * gn))


def forward_flops_per_token(cfg: dict, seq_len: int) -> float:
    """Forward FLOPs per token (the chunked SSD's do not depend on the
    sequence's length)."""
    per_layer = matmul_flops_per_token(cfg) + ssd_flops_per_token(cfg)
    return cfg["n_layers"] * per_layer + 2 * cfg["d_model"] * cfg["vocab"]
