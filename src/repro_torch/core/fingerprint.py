"""What a measurement is valid for: backend × device × dtype.

Counterpart of ``HardwareFingerprint`` and ``cache_base_dir`` in the
reference package's ``core/profile_store.py``. The reference stamps
backends that are not JAX's with the host ISA (``platform.machine()``),
which would let a CPU run and an H100 run of the same backend share one
atlas. Here the device is the card's name (``torch.cuda.get_device_name``)
or ``"cpu"``, so the two can never mix.
"""

from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path

import torch


@dataclasses.dataclass(frozen=True)
class HardwareFingerprint:
    """What a measurement is valid for: backend × device kind × dtype."""

    backend: str   # registry key, e.g. "cuda" | "torch"
    device: str    # e.g. "NVIDIA H100 80GB HBM3", "cpu"
    dtype: str     # e.g. "float32"

    def slug(self) -> str:
        """Filesystem-safe identifier used in cache filenames."""
        raw = f"{self.backend}-{self.device}-{self.dtype}"
        return re.sub(r"[^A-Za-z0-9._-]+", "_", raw).lower()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "HardwareFingerprint":
        return cls(backend=str(d["backend"]), device=str(d["device"]),
                   dtype=str(d["dtype"]))


def device_label(device: torch.device) -> str:
    """The fingerprint's device string: the card's name, or ``"cpu"``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def cache_base_dir() -> Path:
    """Root of the on-disk caches (``$XDG_CACHE_HOME/repro`` or
    ``~/.cache/repro``), the same root the reference package uses; the
    fingerprint in every file name keeps the two packages' files apart."""
    xdg = os.environ.get("XDG_CACHE_HOME")
    base = Path(xdg) if xdg else Path.home() / ".cache"
    return base / "repro"
