"""``ssd_chunk_roofline``: the SSD's fused intra-chunk kernels (names
holding ``repro_ssd``) against their roofline in the traced window: a
layer's operations and bytes (``roofline.ssm.ssd_chunk_work``) times the
layers that take the chunked form, in percent of the kernels' device
time. A replay runs no Python, so the layers are the model's times the
chunked share of ``select_ssd_mode``'s picks, which the program counts
while Python runs the step (the warm-up and the capture)."""

from h100_bench import readers
from h100_bench.roofline import ssm


def read(rec):
    chunked = readers.count(rec, "ssm.ssd.mode.chunked")
    if not chunked:
        return None
    cfg, p = rec["config"], rec["params"]
    flops, nbytes = ssm.ssd_chunk_work(cfg, p["batch"], p["seq_len"])
    layers = cfg["n_layers"] * chunked / (
        chunked + readers.count(rec, "ssm.ssd.mode.quadratic"))
    return readers.kernel_share(rec, "repro_ssd", flops * layers,
                                nbytes * layers)
