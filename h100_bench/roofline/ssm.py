"""Parameters and forward FLOPs of the ``ssm`` family (Mamba2,
arXiv:2405.21060): the matrix products of every projection, the depthwise
convolution, the SSD in its chunked form (per token and head 2·Q·(N + P)
within the chunk and 4·N·P for the states) and the tied output head.
Elementwise work is left out. Also the operations and bytes of the SSD's
fused intra-chunk kernel (:func:`ssd_chunk_work`).
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


def ssd_chunk_work(cfg: dict, batch: int, seq_len: int) -> tuple:
    """(FLOPs, bytes) of one layer's intra-chunk stage, forward and
    backward, as the fused kernel (``ssd_chunk``) does it: the model's
    Q x Q products over the j <= i triangle with no recomputation (not
    the kernel's float32 operands split in bf16 parts, so that a kernel
    that splits less cannot read over its bound); x, B, C and their
    gradients in bf16, every other tensor in float32, each read or
    written once."""
    s = cfg["ssm"]
    b, q, h, p = batch, s["chunk"], s["n_heads"], s["head_dim"]
    g, n, nc = s["n_groups"], s["d_state"], -(-seq_len // s["chunk"])
    tri = q * (q + 1) // 2
    # C·Bᵀ, dC and dB; K·x, U = Lᵀ·dy and dK = dy·xᵀ; the chunk states,
    # T = B·ds and x·dsᵀ
    flops = 3 * (2 * b * nc * g * tri * n + 2 * b * nc * h * tri * p
                 + 2 * b * nc * h * q * n * p)
    xs, bcs, row = b * nc * q * h * p, b * nc * q * g * n, b * nc * q * h
    states = b * nc * h * n * p
    fwd = 2 * xs + 2 * 2 * bcs + 4 * 3 * row + 4 * xs + 4 * states
    bwd = (2 * xs + 2 * 2 * bcs + 4 * 3 * row + 4 * 2 * xs + 4 * states
           + 2 * xs + 2 * 2 * bcs + 4 * 3 * row)
    return flops, fwd + bwd
