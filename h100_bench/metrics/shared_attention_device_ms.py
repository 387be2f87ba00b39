"""``shared_attention_device_ms``: device time a step of the shared
block's attention (from the normed [hidden, embedding] to the output
projection, adapters included) over every application, forward and
backward: the program's ``hybrid.shared.attn`` and
``hybrid.shared.attn.bwd`` spans."""

from h100_bench import readers


def read(rec):
    return readers.span_ms(rec, "hybrid.shared.attn",
                           "hybrid.shared.attn.bwd")
