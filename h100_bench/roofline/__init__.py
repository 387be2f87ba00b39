"""Operations of the benchmark's steps, from a configuration's shapes, and
the table of peaks they are held against.

The arithmetic of one family of models lives in ``roofline/<family>.py``,
found by the configuration's ``family``; it gives ``param_count(cfg)`` and
``forward_flops_per_token(cfg, seq_len)``. A train step's FLOPs are the
model's: three times the forward pass (the backward pass costs two).
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional

#: Published dense peaks by ``torch.cuda.get_device_name()``: NVIDIA's
#: H100 SXM data sheet (bf16 tensor cores without sparsity; HBM3).
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(device_name)


def family(cfg: dict):
    """The module ``roofline/<cfg["family"]>.py``."""
    return importlib.import_module(f"{__name__}.{cfg['family']}")


def param_count(cfg: dict) -> int:
    return family(cfg).param_count(cfg)


def forward_flops_per_token(cfg: dict, seq_len: int) -> float:
    return family(cfg).forward_flops_per_token(cfg, seq_len)


def train_step_flops(cfg: dict, batch: int, seq_len: int) -> float:
    return 3 * forward_flops_per_token(cfg, seq_len) * batch * seq_len
