"""``idle_pct.train``: share of the traced window of a train cell in
which no kernel or copy ran on the device (``torch.profiler``)."""


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "train" or t is None or t.busy_s <= 0:
        return None
    return 100 * (1 - t.busy_s / t.window_s)
