"""Small same-family configurations for the CPU tests: the program's own
``smoke()`` presets, written as the benchmark's configuration files."""

from __future__ import annotations

import copy

from h100_bench import harness


def config_of(base: dict, pc) -> dict:
    """``base`` (a configuration file's dict) with each size that its
    ``port.same`` names taken from the program's ModelConfig ``pc``."""
    cfg = copy.deepcopy(base)
    for key, attr in cfg["port"]["same"].items():
        *path, last = key.split(".")
        node = cfg
        for part in path:
            node = node[part]
        node[last] = harness.lookup(pc, attr)
    return cfg


def files(cell: str, **params) -> tuple:
    """(files, program config) of ``cell`` at the smoke size, the mix's
    parameters replaced by ``params``."""
    from repro_torch import configs
    f = copy.deepcopy(harness.cell_files(cell))
    pc = configs.get_smoke(f["config"]["port"]["config"])
    f["config"] = config_of(f["config"], pc)
    f["mix"]["params"].update(params)
    harness.check_port_config(f["config"], pc)
    return f, pc


TRAIN = dict(seq_len=64, batch=2, check_steps=3, trace_steps=1)
