"""``adamw_update_device_ms``: device time a step of the program's
``adamw.update`` span: the optimizer whole, its working-copy cast and
clip norm with its ``_foreach`` passes."""

from h100_bench import readers


def read(rec):
    return readers.span_ms(rec, "adamw.update")
