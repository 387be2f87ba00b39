"""``train_step_wall_ms``: median of ``train.loop.train``'s ``on_step``
wall times over the window (host clock)."""

import statistics


def read(rec):
    if rec.get("kind") != "train" or not rec.get("step_walls"):
        return None
    return statistics.median(rec["step_walls"]) * 1e3
