"""Parameters and forward FLOPs of the ``hybrid`` family (Zamba2 with its
published shared block, arXiv:2411.15242): the Mamba2 layers as
``roofline/ssm.py`` counts them, and at each application of the shared
block the matrix products of q, k, v (from [hidden, embedding], 2·d_model
wide) and o, the causal attention (q·kᵀ and P·v over the keys up to each
position), the GLU MLP's gate_up and down, every adapter and the
application's ``linear``; then the tied output head. Elementwise work
(norms, RoPE, the softmax, GELU) is left out.
"""

from __future__ import annotations

from . import ssm


def _widths(cfg: dict):
    sh = cfg["shared"]
    hq = sh["n_heads"] * sh["head_dim"]
    hkv = sh["n_kv_heads"] * sh["head_dim"]
    return sh, 2 * cfg["d_model"], hq, hkv


def _adapted(cfg: dict) -> list:
    """(input, output) widths of each adapter of an application."""
    sh, din, hq, hkv = _widths(cfg)
    pairs = [(cfg["d_model"], 2 * sh["d_ff"])]
    if sh["attn_adapters"]:
        pairs += [(din, hq), (din, hkv), (din, hkv)]
    return pairs


def param_count(cfg: dict) -> int:
    """Every parameter of the model as it is run: the Mamba2 model's
    (``roofline/ssm.py``), each memory block (two norms, q, k, v, o,
    gate_up, down) and each application's adapters and ``linear``."""
    d = cfg["d_model"]
    sh, din, hq, hkv = _widths(cfg)
    block = din + din * (hq + 2 * hkv) + hq * d + d + 3 * d * sh["d_ff"]
    app = d * d + sum(sh["adapter_rank"] * (i + o) for i, o in _adapted(cfg))
    return ssm.param_count(cfg) + sh["num_mem_blocks"] * block \
        + len(sh["hybrid_layer_ids"]) * app


def shared_flops_per_token(cfg: dict, seq_len: int) -> float:
    """One application of the shared block, a token: its products with
    the weights and, for causal attention, 2·2·H·Dh a visible key, on
    average (seq_len + 1) / 2 of them."""
    d = cfg["d_model"]
    sh, din, hq, hkv = _widths(cfg)
    weights = (din * (hq + 2 * hkv) + hq * d + 3 * d * sh["d_ff"] + d * d
               + sum(sh["adapter_rank"] * (i + o) for i, o in _adapted(cfg)))
    attn = 2 * sh["n_heads"] * sh["head_dim"] * (seq_len + 1)
    return 2 * weights + attn


def forward_flops_per_token(cfg: dict, seq_len: int) -> float:
    """Forward FLOPs per token at ``seq_len`` positions."""
    mamba = cfg["n_layers"] * (ssm.matmul_flops_per_token(cfg)
                               + ssm.ssd_flops_per_token(cfg))
    shared = len(cfg["shared"]["hybrid_layer_ids"]) * \
        shared_flops_per_token(cfg, seq_len)
    return mamba + shared + 2 * cfg["d_model"] * cfg["vocab"]
