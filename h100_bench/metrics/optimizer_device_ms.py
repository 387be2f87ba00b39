"""``optimizer_device_ms``: device time a step of the ``_foreach``
kernels (``multi_tensor_apply``) that ``optim.adamw`` runs, in the traced
window (``torch.profiler``)."""


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "train" or t is None or not rec["trace_steps"]:
        return None
    s = t.device_s(contains="multi_tensor_apply")
    return s / rec["trace_steps"] * 1e3 if s > 0 else None
