"""``attention_train_roofline``: training's attention kernels (names
holding ``repro_flash_train``) against their roofline in the traced
window. The work of one application of the shared block's attention,
forward and backward: 4·D FLOPs a visible (query, key) pair and query
head forward (q·kᵀ, P·v) and twice that backward (dv, dP, dq, dk), with no
recomputation and no split parts counted; q, k, v, O, dO, dq, dk and dv in
bf16 and the log-sum-exp in float32, each once. Times the applications
that take the kernels: a replay runs no Python, so they are the
configuration's applications times the kernels' share of the calls the
program counts while Python runs the step (``attention.train.kernel`` and
``.plain``). This counts less than the kernels execute, so the share
cannot pass 100 %."""

from h100_bench import readers


def visible_pairs(seq: int, causal: bool, window: int) -> int:
    """(query, key) pairs of ``seq`` positions that the masks keep."""
    return sum((q if causal else seq - 1)
               - (max(0, q - window + 1) if window > 0 else 0) + 1
               for q in range(seq))


def work(cfg: dict, batch: int, seq: int):
    """(FLOPs, bytes) of one application, forward and backward."""
    sh = cfg["shared"]
    h, hkv, d = sh["n_heads"], sh["n_kv_heads"], sh["head_dim"]
    flops = 3 * 4 * batch * h * d * visible_pairs(seq, True, sh["window"])
    nbytes = 2 * 4 * batch * seq * (h + hkv) * d + 4 * batch * h * seq
    return flops, nbytes


def read(rec):
    kernel = readers.count(rec, "attention.train.kernel")
    if not kernel:
        return None
    cfg, p = rec["config"], rec["params"]
    flops, nbytes = work(cfg, p["batch"], p["seq_len"])
    apps = len(cfg["shared"]["hybrid_layer_ids"]) * kernel / (
        kernel + readers.count(rec, "attention.train.plain"))
    return readers.kernel_share(rec, "repro_flash_train", flops * apps,
                                nbytes * apps)
