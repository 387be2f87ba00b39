"""``shared_block_device_ms``: device time a step of the published shared
block over its every application, forward and backward: the program's
``hybrid.shared`` and ``hybrid.shared.bwd`` spans, the medians of their
totals over the steps read."""

from h100_bench import readers


def read(rec):
    return readers.span_ms(rec, "hybrid.shared", "hybrid.shared.bwd")
