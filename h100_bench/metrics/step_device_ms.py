"""``step_device_ms``: device time of the program's ``train.step`` span a
step (CUDA events that the captured graph records on each replay), the
median over the steps read after the profiler's window."""

from h100_bench import readers


def read(rec):
    return readers.span_ms(rec, "train.step")
