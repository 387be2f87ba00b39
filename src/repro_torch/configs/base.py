"""Architecture config registry and input-shape cells.

Own copy of the reference's ``configs/base.py``. Each ported architecture
lives in ``configs/<id>.py`` exposing ``config()`` (the exact published
configuration) and ``smoke()`` (a reduced same-family variant for CPU
tests). All ten of the reference's architectures are ported: the
dense, moe, ssm, hybrid, encdec and vlm families.

Shape cells:
  train_4k     seq 4096,   global_batch 256  (train_step)
  prefill_32k  seq 32768,  global_batch 32   (prefill)
  decode_32k   seq 32768,  global_batch 128  (serve_step, 1 new token)
  long_500k    seq 524288, global_batch 1    (decode; SSM/hybrid only)
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

from repro_torch.models.transformer import ModelConfig

ARCH_IDS = (
    "mamba2_370m",
    "whisper_tiny",
    "internvl2_76b",
    "gemma2_9b",
    "glm4_9b",
    "phi3_mini",
    "yi_9b",
    "arctic_480b",
    "olmoe_1b_7b",
    "zamba2_1p2b",
)

# Assignment ids → module names (dashes/dots not importable).
ALIASES = {
    "mamba2-370m": "mamba2_370m",
    "whisper-tiny": "whisper_tiny",
    "internvl2-76b": "internvl2_76b",
    "gemma2-9b": "gemma2_9b",
    "glm4-9b": "glm4_9b",
    "phi3-mini-3.8b": "phi3_mini",
    "yi-9b": "yi_9b",
    "arctic-480b": "arctic_480b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "zamba2-1.2b": "zamba2_1p2b",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Assignment skip rules. Returns (run?, reason-if-skipped)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("pure full-attention arch: 524288-token dense decode "
                       "requires sub-quadratic attention (DESIGN.md §6)")
    return True, ""


def normalize(name: str) -> str:
    return ALIASES.get(name, name)


def _module(name: str):
    arch = normalize(name)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{', '.join(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke()


def all_cells():
    """Every (arch, shape) pair with its skip status — the 40-cell table."""
    out = []
    for arch in ARCH_IDS:
        cfg = get(arch)
        for sname, sspec in SHAPES.items():
            run, why = shape_applicable(cfg, sspec)
            out.append((arch, sname, run, why))
    return out
