"""``capture_s``: host seconds of the train step's capture in set-up: the
program's ``train.capture.warmup`` (the eager first step) and
``train.capture.record`` (the CUDA graph's capture) spans."""

from h100_bench import readers


def read(rec):
    ms = readers.span_ms(rec, "train.capture.warmup", "train.capture.record",
                         clock="host")
    return None if ms is None else ms / 1e3
