"""Plain float32 PyTorch references of the benchmark's configurations,
one module a family (``reference/<family>.py``, found by the
configuration's ``family``), each giving ``param_spec(cfg)`` and
``forward(params, cfg, tokens, prec, checkpoint)``.

They import neither ``jax`` nor the packages under test, and take no
weight, table or state that the program made: the harness draws the
weights from the seed and hands the same tensors to both sides.
"""

import importlib


def family(cfg: dict):
    """The module ``reference/<cfg["family"]>.py``."""
    return importlib.import_module(f"{__name__}.{cfg['family']}")
