"""Persistent kernel-profile storage — calibrate once per machine.

The port's counterpart of the reference package's
``core/profile_store.py``, with the reference's schema (version 1), so a
profile either package writes is read by the other. A
:class:`~repro_torch.core.perfmodel.TableProfile` is serialized to
versioned JSON together with a :class:`HardwareFingerprint` (backend,
device, dtype) so a profile calibrated on one machine is never silently
applied to another. For a device backend the device is the card's name,
or ``"cpu"`` (:func:`repro_torch.core.fingerprint.device_label`); for a
host backend (``blas``, ``numpy``) it is the host's ISA, as in the
reference (:func:`repro_torch.core.fingerprint.host_label`).

Layout on disk (one file per fingerprint)::

    <cache dir>/profile-<backend>-<device>-<dtype>.json

where ``<cache dir>`` is, in order of precedence:

1. the explicit ``path``/``directory`` argument,
2. ``$REPRO_PROFILE_DIR``,
3. ``$XDG_CACHE_HOME/repro/profiles`` or ``~/.cache/repro/profiles``.

Set ``REPRO_NO_PROFILE_CACHE=1`` to make :func:`load_default_profile`
return ``None`` unconditionally.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Tuple

import torch

from .fingerprint import (HardwareFingerprint, cache_base_dir, device_label,
                          host_label)
from .perfmodel import TableProfile

__all__ = [
    "FingerprintMismatchError", "HardwareFingerprint", "ProfileStoreError",
    "SCHEMA_VERSION", "SchemaVersionError", "cache_dir",
    "current_fingerprint", "load_default_profile", "load_profile",
    "profile_path", "save_profile",
]

SCHEMA_VERSION = 1

_ENV_DIR = "REPRO_PROFILE_DIR"
_ENV_DISABLE = "REPRO_NO_PROFILE_CACHE"


class ProfileStoreError(RuntimeError):
    """Base class for profile persistence failures."""


class FingerprintMismatchError(ProfileStoreError):
    """A stored profile was calibrated on different hardware/backend/dtype."""


class SchemaVersionError(ProfileStoreError):
    """A stored profile uses a schema this build cannot read."""


def current_fingerprint(backend: str = "cuda", dtype: str = "float32",
                        device="cuda") -> HardwareFingerprint:
    """Fingerprint of a backend's measurements on ``device``: the card's
    name for ``cuda`` (raises without a card), ``"cpu"`` for the CPU —
    the fingerprint :meth:`TorchBackend.fingerprint` stamps. A host
    backend (``blas``, ``numpy``: registered with ``shard_mode``
    ``"process"``) runs on the host whatever ``device`` says: its device
    is the host's ISA, as in the reference, and it needs no card."""
    from .backends import backend_shard_mode, register_torch_backends

    register_torch_backends()
    try:
        on_host = backend_shard_mode(backend) == "process"
    except KeyError:  # an unregistered label (tests, foreign caches)
        on_host = False
    if on_host:
        return HardwareFingerprint(backend=backend, device=host_label(),
                                   dtype=dtype)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to use the "
            "CPU's measurements explicitly")
    return HardwareFingerprint(backend=backend, device=device_label(device),
                               dtype=dtype)


def cache_dir() -> Path:
    env = os.environ.get(_ENV_DIR)
    if env:
        return Path(env)
    return cache_base_dir() / "profiles"


def profile_path(fingerprint: HardwareFingerprint,
                 directory: Optional[Path] = None) -> Path:
    d = Path(directory) if directory is not None else cache_dir()
    return d / f"profile-{fingerprint.slug()}.json"


def save_profile(
    profile: TableProfile,
    fingerprint: HardwareFingerprint,
    path: Optional[Path] = None,
    directory: Optional[Path] = None,
    meta: Optional[dict] = None,
) -> Path:
    """Write ``profile`` as versioned JSON; returns the file written.

    ``path`` wins over ``directory``; with neither, the default cache dir
    is used. Parent directories are created. The write is atomic (tmp file
    + rename) so a crashed calibration never leaves a torn cache.
    """
    out = Path(path) if path is not None else profile_path(
        fingerprint, directory)
    out.parent.mkdir(parents=True, exist_ok=True)
    doc = {
        "version": SCHEMA_VERSION,
        "fingerprint": fingerprint.to_dict(),
        "peak_flops": profile.peak(),
        "entries": [
            {"kind": kind, "dims": list(dims), "seconds": t}
            for (kind, dims), t in sorted(profile.table.items())
        ],
        "meta": dict(meta or {}),
    }
    # Unique per writer: concurrent saves must not interleave in a shared
    # tmp file.
    tmp = out.with_suffix(
        f"{out.suffix}.{os.getpid()}.{os.urandom(4).hex()}.tmp")
    tmp.write_text(json.dumps(doc, indent=1, sort_keys=True))
    tmp.replace(out)
    return out


def load_profile(
    path: Path,
    expected_fingerprint: Optional[HardwareFingerprint] = None,
) -> Tuple[TableProfile, HardwareFingerprint]:
    """Read a profile; reject schema/fingerprint mismatches loudly."""
    try:
        doc = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ProfileStoreError(f"unreadable profile {path}: {e}") from e
    version = doc.get("version")
    if version != SCHEMA_VERSION:
        raise SchemaVersionError(
            f"profile {path} has schema version {version!r}; "
            f"this build reads version {SCHEMA_VERSION}")
    fp = HardwareFingerprint.from_dict(doc["fingerprint"])
    if expected_fingerprint is not None and fp != expected_fingerprint:
        raise FingerprintMismatchError(
            f"profile {path} was calibrated for {fp}, "
            f"but this process targets {expected_fingerprint}")
    table = {
        (str(e["kind"]), tuple(int(d) for d in e["dims"])): float(e["seconds"])
        for e in doc["entries"]
    }
    return TableProfile(peak_flops=float(doc["peak_flops"]),
                        table=table), fp


def load_default_profile(
    backend: str = "cuda",
    dtype: str = "float32",
    device="cuda",
) -> Optional[TableProfile]:
    """Auto-load the cached profile of ``backend`` on ``device``, if any.

    Returns ``None`` when no valid cache exists — callers fall back to the
    analytical model, so a corrupt or stale cache degrades to the
    uncalibrated behaviour instead of crashing. Without a card, a
    ``device`` of ``"cuda"`` raises (:func:`current_fingerprint`).
    """
    if os.environ.get(_ENV_DISABLE):
        return None
    fp = current_fingerprint(backend=backend, dtype=dtype, device=device)
    path = profile_path(fp)
    if not path.is_file():
        return None
    try:
        profile, _ = load_profile(path, expected_fingerprint=fp)
    except ProfileStoreError:
        return None
    return profile
