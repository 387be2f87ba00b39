"""``setup_s``: seconds from the process's start to the first timed step
(host clock): imports, weights on the device, the program's warm-up
and capture, and the steps the correctness check reads."""


def read(rec):
    return rec.get("setup_s")
