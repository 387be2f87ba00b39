"""``ssd_device_ms``: device time a step of the SSD over every layer,
forward and backward: the program's ``ssm.ssd`` and ``ssm.ssd.bwd``
spans, the medians of their totals over the steps read."""

from h100_bench import readers


def read(rec):
    return readers.span_ms(rec, "ssm.ssd", "ssm.ssd.bwd")
