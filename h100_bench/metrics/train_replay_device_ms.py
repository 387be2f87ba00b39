"""``train_replay_device_ms``: device time of one step in the traced
window (kernels, copies), the sum over the traced steps divided by their
count (``torch.profiler``)."""


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "train" or t is None or not rec["trace_steps"]:
        return None
    s = t.device_s()
    return s / rec["trace_steps"] * 1e3 if s > 0 else None
