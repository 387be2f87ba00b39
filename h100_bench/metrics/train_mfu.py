"""``train_mfu``: the model FLOPs of a step's tokens
(``roofline.train_step_flops``) over the median step time times the
card's bf16 peak, in percent."""

import statistics

from h100_bench import roofline


def read(rec):
    peak = roofline.peaks(rec.get("device_name", ""))
    if rec.get("kind") != "train" or peak is None or not rec["step_walls"]:
        return None
    p = rec["params"]
    flops = roofline.train_step_flops(rec["config"], p["batch"],
                                      p["seq_len"])
    return 100 * flops / (statistics.median(rec["step_walls"])
                          * peak["bf16_flops"])
