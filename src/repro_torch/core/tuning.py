"""Launch autotuning: search space, model pruning, persistence.

The port's counterpart of the reference package's ``core/tuning.py``.
The paper closes by conjecturing that FLOP counts must be combined with
kernel performance models to pick optimal algorithms, and a performance
model is only as honest as the kernels it measures. Each hand-written
kernel of the port picks its launch (tile and contraction split, the
chain's piece, gemm_syrk's chunk width and cluster size) by a cost model
fitted once on the card at the sweep's shapes; this module is the
search-space half of the tuner that checks that pick by measurement at
any other shape (the measurement loop lives in
:mod:`repro_torch.kernels.autotune`):

* :func:`candidate_configs` — the kernel's own launch candidates
  (``candidates`` of :mod:`repro_torch.kernels.gemm`, ``syrk``,
  ``chain_gemm``, ``gemm_syrk``), as table entries;
* :func:`prune_candidates` — the pre-filter: a launch whose dynamic
  shared memory per CTA exceeds the card's opt-in limit
  (``sharedMemPerBlockOptin``) is rejected, then the rest are ranked by
  the kernel's own cost model (``gemm_cost``, ``syrk_cost``,
  ``chain_cost``, ``gemm_syrk_cost``; symm through ``gemm_cost``, as
  ``symm_config`` ranks it); those modeled above ``slack`` × the best
  are rejected and the cheapest ``budget`` survive. The model's own pick
  is always kept: it is what runs without a table, the counterpart of
  the reference's ``DEFAULT_CONFIGS``;
* :class:`TuningTable` — the persisted winners, keyed ``(kind, dims)``
  with the reference's nearest-entry fallback in log-dim space (which
  the ``cuda`` backend's dispatch does not use), saved in the reference's
  JSON layout under the port's fingerprint:
  ``<cache dir>/tuning-cuda-<card name>-float32.json``.

Entries are the kernels' launch knobs (``config_to_dict``): gemm, syrk
and symm ``{"tile", "split"}`` (``tile`` indexes the GEMM's ``TILES``),
the chain ``{"piece"}`` (its ``TILES``), gemm_syrk ``{"bl",
"cluster"}``. A lookup goes through the kernel's ``config_from_dict``,
which returns None for anything outside its candidates at those dims: a
foreign or hand-edited entry is dropped and the model's pick runs.

``calibrate --tune`` writes the table;
:class:`~repro_torch.core.backends.CudaBackend` auto-loads it. Set
``REPRO_NO_TUNING=1`` to kill tuned lookups (the wrappers' launch rules
pick every launch).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..kernels import chain_gemm as _chain
from ..kernels import gemm as _gemm
from ..kernels import gemm_syrk as _gemm_syrk
from ..kernels import symm as _symm
from ..kernels import syrk as _syrk
from .profile_store import (
    FingerprintMismatchError,
    HardwareFingerprint,
    ProfileStoreError,
    SchemaVersionError,
    cache_dir,
    current_fingerprint,
)

TUNING_SCHEMA_VERSION = 1

#: Env kill-switch: disables both TuningTable auto-load and tuned lookups
#: on the ``cuda`` backend (the wrappers' launch rules pick every launch).
ENV_NO_TUNING = "REPRO_NO_TUNING"

#: The kernel module of each tunable kind. ``tri2full`` is data movement
#: with no launch knob: nothing to tune.
KERNELS = {"gemm": _gemm, "syrk": _syrk, "symm": _symm,
           "chain_gemm": _chain, "gemm_syrk": _gemm_syrk}
TUNABLE_KINDS: Tuple[str, ...] = tuple(KERNELS)


def tuning_disabled() -> bool:
    """Whether ``REPRO_NO_TUNING`` kills tuned lookups."""
    return bool(os.environ.get(ENV_NO_TUNING))


@dataclasses.dataclass(frozen=True)
class CardLimits:
    """What a launch's validity and modeled cost depend on: the SMs, the
    resident clusters of 1..8 CTAs (``cudaOccupancyMaxActiveClusters``)
    and the dynamic shared memory a block may opt in to."""

    sms: int = _gemm.SMS
    active: Tuple[int, ...] = _gemm_syrk.ACTIVE_CLUSTERS
    smem_bytes: int = _gemm_syrk.SMEM_BYTES


def card_limits(device="cpu") -> CardLimits:
    """The card's own :class:`CardLimits` on a CUDA device; the H100 SXM's
    (the wrappers' defaults) on the CPU, where the plain versions run."""
    device = torch.device(device)
    if device.type != "cuda":
        return CardLimits()
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    props = torch.cuda.get_device_properties(idx)
    return CardLimits(sms=_gemm.sm_count(idx),
                      active=_gemm_syrk.active_clusters(idx),
                      smem_bytes=int(props.shared_memory_per_block_optin))


def config_key(config: Dict[str, int]) -> Tuple[Tuple[str, int], ...]:
    """Hashable, order-independent identity of a candidate config."""
    return tuple(sorted(config.items()))


def _check_kind(kind: str) -> None:
    if kind not in TUNABLE_KINDS:
        raise ValueError(
            f"kernel kind {kind!r} is not tunable; expected one of "
            f"{TUNABLE_KINDS}")


def kernel_candidates(kind: str, dims: Sequence[int]) -> list:
    """The kernel's own launch candidates at ``dims``."""
    _check_kind(kind)
    dims = tuple(int(d) for d in dims)
    if kind == "gemm":
        return _gemm.candidates(dims[2])
    if kind == "syrk":
        return _syrk.syrk_candidates(dims[1])
    if kind == "symm":
        return _gemm.candidates(dims[0])
    if kind == "chain_gemm":
        return list(_chain.CONFIGS)
    return _gemm_syrk.candidates(dims[0])


def candidate_configs(kind: str, dims: Sequence[int]) -> List[Dict[str, int]]:
    """The search space of one ``(kind, dims)`` request: the kernel's
    candidates as table entries, without repeats."""
    out: List[Dict[str, int]] = []
    for cfg in kernel_candidates(kind, dims):
        d = KERNELS[kind].config_to_dict(cfg)
        if d not in out:
            out.append(d)
    return out


def launch_config(kind: str, dims: Sequence[int], config: Dict,
                  limits: CardLimits = CardLimits()):
    """The launch a table entry names at ``dims``, or None where the
    kernel's ``config_from_dict`` refuses it."""
    _check_kind(kind)
    dims = tuple(int(d) for d in dims)
    if kind == "gemm_syrk":
        return _gemm_syrk.config_from_dict(dims, config, limits.active)
    return KERNELS[kind].config_from_dict(dims, config)


def model_launch(kind: str, dims: Sequence[int],
                 limits: CardLimits = CardLimits()):
    """The launch the wrapper's rule picks at ``dims`` (None for a
    gemm_syrk no launch holds)."""
    _check_kind(kind)
    m, *rest = (int(d) for d in dims)
    if kind == "gemm":
        return _gemm.gemm_config(m, rest[0], rest[1], limits.sms)
    if kind == "syrk":
        return _syrk.syrk_config(m, rest[0], limits.sms)
    if kind == "symm":
        return _symm.symm_config(m, rest[0], limits.sms)
    if kind == "chain_gemm":
        return _chain.chain_config(m, *rest, limits.sms)
    return _gemm_syrk.gemm_syrk_config(m, *rest, limits.active)


def default_config(kind: str, dims: Sequence[int],
                   limits: CardLimits = CardLimits()) -> Optional[Dict]:
    """The model's pick as a table entry: what runs without a table."""
    cfg = model_launch(kind, dims, limits)
    return None if cfg is None else KERNELS[kind].config_to_dict(cfg)


def _order(kind: str, dims: Tuple[int, ...], cfg,
           limits: CardLimits) -> Tuple:
    """(modeled µs, then the launch rule's own tie-breaks): sorting by it
    puts the model's pick first."""
    if kind == "gemm":
        m, n, _ = dims
        return (_gemm.gemm_cost(m, n, cfg, limits.sms), cfg.config,
                cfg.split)
    if kind == "syrk":
        return (_syrk.syrk_cost(dims[0], cfg, limits.sms), cfg.config,
                cfg.split)
    if kind == "symm":
        m, n = dims
        return (_gemm.gemm_cost(m, n, cfg, limits.sms), cfg.config,
                cfg.split)
    if kind == "chain_gemm":
        return (_chain.chain_cost(*dims, cfg, limits.sms), cfg.config)
    return (_gemm_syrk.gemm_syrk_cost(*dims, cfg, limits.active), -cfg.bl,
            cfg.cluster)


def modeled_seconds(kind: str, dims: Sequence[int], config: Dict,
                    limits: CardLimits = CardLimits()) -> float:
    """The kernel's cost model of one candidate launch, in seconds."""
    dims = tuple(int(d) for d in dims)
    cfg = launch_config(kind, dims, config, limits)
    if cfg is None:
        raise ValueError(f"{kind}{dims}: {config} is not a launch of the "
                         f"kernel")
    return _order(kind, dims, cfg, limits)[0] * 1e-6


def _smem(kind: str, dims: Tuple[int, ...], cfg) -> int:
    return cfg.smem_bytes(dims[0]) if kind == "gemm_syrk" else cfg.smem_bytes


def smem_bytes(kind: str, dims: Sequence[int], config: Dict,
               limits: CardLimits = CardLimits()) -> int:
    """Dynamic shared memory per CTA of one candidate launch."""
    dims = tuple(int(d) for d in dims)
    cfg = launch_config(kind, dims, config, limits)
    if cfg is None:
        raise ValueError(f"{kind}{dims}: {config} is not a launch of the "
                         f"kernel")
    return _smem(kind, dims, cfg)


@dataclasses.dataclass(frozen=True)
class RejectedCandidate:
    """One pruned config and why it never reached the timer."""

    config: Dict[str, int]
    reason: str    # "invalid" | "smem" | "model" | "budget"
    detail: str


@dataclasses.dataclass
class PruneReport:
    """What the pre-filter decided for one ``(kind, dims)`` request.

    ``survivors`` are ordered cheapest-modeled first and always contain
    ``default``, the model's pick; ``modeled`` (seconds) aligns with
    ``survivors``.
    """

    kind: str
    dims: Tuple[int, ...]
    survivors: List[Dict[str, int]]
    modeled: List[float]
    rejected: List[RejectedCandidate]
    default: Dict[str, int]


def prune_candidates(
    kind: str,
    dims: Sequence[int],
    candidates: Optional[Iterable[Dict[str, int]]] = None,
    *,
    limits: CardLimits = CardLimits(),
    slack: float = 2.0,
    budget: int = 8,
) -> PruneReport:
    """The pre-filter: decide which candidates deserve timing.

    Rules, applied in order and all before any timing:

    1. **invalid** — not a launch of the kernel at these dims
       (``config_from_dict`` refuses it; only a hand-given list has
       such entries);
    2. **smem** — dynamic shared memory per CTA above
       ``limits.smem_bytes``: such a launch fails;
    3. **model** — modeled time (the kernel's own cost model) above
       ``slack`` × the best candidate's;
    4. **budget** — beyond the ``budget`` cheapest-modeled survivors.

    The model's pick is always kept (re-appended if the rules dropped
    it), so the measured winner is never slower than it as measured.
    """
    _check_kind(kind)
    dims = tuple(int(d) for d in dims)
    if candidates is None:
        candidates = candidate_configs(kind, dims)
    default = default_config(kind, dims, limits)
    if default is None:
        raise ValueError(f"{kind}{dims}: no launch of the kernel holds "
                         f"these dims")
    kept: List[Tuple[Tuple, Dict[str, int]]] = []
    rejected: List[RejectedCandidate] = []
    for config in candidates:
        config = dict(config)
        cfg = launch_config(kind, dims, config, limits)
        if cfg is None:
            rejected.append(RejectedCandidate(
                config, "invalid", "not a launch of the kernel here"))
            continue
        need = _smem(kind, dims, cfg)
        if need > limits.smem_bytes:
            rejected.append(RejectedCandidate(
                config, "smem",
                f"needs {need} B of shared memory > {limits.smem_bytes} B"))
            continue
        kept.append((_order(kind, dims, cfg, limits), config))
    kept.sort(key=lambda e: e[0])
    survivors: List[Dict[str, int]] = []
    modeled: List[float] = []
    if kept:
        best = kept[0][0][0]
        for order, config in kept:
            us = order[0]
            if us > slack * best and not math.isclose(us, slack * best):
                rejected.append(RejectedCandidate(
                    config, "model",
                    f"modeled {us:.3g}us > {slack:g}x best {best:.3g}us"))
            elif len(survivors) < budget:
                survivors.append(config)
                modeled.append(us * 1e-6)
            else:
                rejected.append(RejectedCandidate(
                    config, "budget",
                    f"budget cap: {budget} cheaper candidates"))
    if default not in survivors:
        rejected = [r for r in rejected if r.config != default]
        survivors.append(default)
        modeled.append(modeled_seconds(kind, dims, default, limits))
    return PruneReport(kind=kind, dims=dims, survivors=survivors,
                       modeled=modeled, rejected=rejected, default=default)


# ------------------------------------------------------------ the table ---


@dataclasses.dataclass
class TunedEntry:
    """The persisted outcome of tuning one ``(kind, dims)`` request."""

    config: Dict[str, int]
    seconds: float          # measured time of the winning config
    default_seconds: float  # measured time of the model's pick
    timed: int              # candidates that reached the timer
    pruned: int             # candidates the pre-filter rejected


class TuningTable:
    """Winning launch configs per ``(kind, dims)``, with nearest fallback.

    :meth:`config` is the reference's rule: exact hits serve the tuned
    shapes, unseen shapes borrow the config of the nearest same-kind
    entry in log-dim space. The ``cuda`` backend dispatches exact entries
    only (:meth:`entry`) and leaves unseen dims to the wrapper's launch
    rule (:class:`~repro_torch.core.backends.CudaBackend`).
    """

    def __init__(self, entries: Optional[Dict[Tuple[str, Tuple[int, ...]],
                                              TunedEntry]] = None,
                 meta: Optional[dict] = None):
        self.entries: Dict[Tuple[str, Tuple[int, ...]], TunedEntry] = dict(
            entries or {})
        self.meta = dict(meta or {})

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, key: Tuple[str, Tuple[int, ...]]) -> bool:
        return key in self.entries

    def set(self, kind: str, dims: Sequence[int],
            entry: TunedEntry) -> None:
        self.entries[(kind, tuple(int(d) for d in dims))] = entry

    def entry(self, kind: str, dims: Sequence[int]
              ) -> Optional[TunedEntry]:
        """Exact-match entry, or ``None``."""
        return self.entries.get((kind, tuple(int(d) for d in dims)))

    def config(self, kind: str, dims: Sequence[int]
               ) -> Optional[Dict[str, int]]:
        """Winning config for ``(kind, dims)`` — exact or nearest.

        Nearest = smallest squared log-dim distance among same-kind,
        same-arity entries, ties to the smaller dims. ``None`` when the
        table has no entry of this kind.
        """
        dims = tuple(int(d) for d in dims)
        hit = self.entries.get((kind, dims))
        if hit is not None:
            return dict(hit.config)
        best: Optional[Tuple[float, Tuple[int, ...]]] = None
        for (ekind, edims), entry in self.entries.items():
            if ekind != kind or len(edims) != len(dims):
                continue
            dist = sum(
                (math.log(max(a, 2)) - math.log(max(b, 2))) ** 2
                for a, b in zip(dims, edims))
            if best is None or (dist, edims) < best:
                best = (dist, edims)
        if best is None:
            return None
        return dict(self.entries[(kind, best[1])].config)

    def digest(self) -> str:
        """Short identity of the entries' configs: what a tuned sweep's
        atlas header records."""
        doc = sorted((kind, list(dims), sorted(e.config.items()))
                     for (kind, dims), e in self.entries.items())
        return hashlib.sha256(json.dumps(doc).encode()).hexdigest()[:16]


# -------------------------------------------------------------- storage ---


def tuning_path(fingerprint: HardwareFingerprint,
                directory: Optional[Path] = None) -> Path:
    """Where this fingerprint's tuning table lives (profile cache dir)."""
    d = Path(directory) if directory is not None else cache_dir()
    return d / f"tuning-{fingerprint.slug()}.json"


def save_tuning_table(
    table: TuningTable,
    fingerprint: HardwareFingerprint,
    path: Optional[Path] = None,
    directory: Optional[Path] = None,
    meta: Optional[dict] = None,
) -> Path:
    """Write the table as versioned JSON (atomic tmp-file + rename)."""
    out = Path(path) if path is not None else tuning_path(fingerprint,
                                                          directory)
    out.parent.mkdir(parents=True, exist_ok=True)
    doc = {
        "version": TUNING_SCHEMA_VERSION,
        "fingerprint": fingerprint.to_dict(),
        "entries": [
            {"kind": kind, "dims": list(dims), "config": e.config,
             "seconds": e.seconds, "default_seconds": e.default_seconds,
             "timed": e.timed, "pruned": e.pruned}
            for (kind, dims), e in sorted(table.entries.items())
        ],
        "meta": {**table.meta, **(meta or {})},
    }
    tmp = out.with_suffix(
        f"{out.suffix}.{os.getpid()}.{os.urandom(4).hex()}.tmp")
    tmp.write_text(json.dumps(doc, indent=1, sort_keys=True))
    tmp.replace(out)
    return out


def load_tuning_table(
    path: Path,
    expected_fingerprint: Optional[HardwareFingerprint] = None,
) -> Tuple[TuningTable, HardwareFingerprint]:
    """Read a tuning table; reject schema/fingerprint mismatches loudly."""
    try:
        doc = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ProfileStoreError(f"unreadable tuning table {path}: {e}") from e
    version = doc.get("version")
    if version != TUNING_SCHEMA_VERSION:
        raise SchemaVersionError(
            f"tuning table {path} has schema version {version!r}; "
            f"this build reads version {TUNING_SCHEMA_VERSION}")
    fp = HardwareFingerprint.from_dict(doc["fingerprint"])
    if expected_fingerprint is not None and fp != expected_fingerprint:
        raise FingerprintMismatchError(
            f"tuning table {path} was tuned for {fp}, "
            f"but this process targets {expected_fingerprint}")
    entries = {}
    try:
        for e in doc["entries"]:
            key = (str(e["kind"]), tuple(int(d) for d in e["dims"]))
            entries[key] = TunedEntry(
                config={str(k): int(v) for k, v in e["config"].items()},
                seconds=float(e["seconds"]),
                default_seconds=float(e.get("default_seconds", 0.0)),
                timed=int(e.get("timed", 0)),
                pruned=int(e.get("pruned", 0)))
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise ProfileStoreError(f"malformed tuning table {path}: {e}") from e
    return TuningTable(entries=entries, meta=dict(doc.get("meta") or {})), fp


def _load_for(fingerprint: HardwareFingerprint) -> Optional[TuningTable]:
    """The cached table of ``fingerprint``, or None under
    ``REPRO_NO_TUNING``, without a file, or for a bad one."""
    if tuning_disabled():
        return None
    path = tuning_path(fingerprint)
    if not path.is_file():
        return None
    try:
        table, _ = load_tuning_table(path, expected_fingerprint=fingerprint)
    except ProfileStoreError:
        return None
    return table


def load_default_tuning_table(
    backend: str = "cuda",
    dtype: str = "float32",
    device="cuda",
) -> Optional[TuningTable]:
    """Auto-load the cached tuning table of ``backend`` on ``device``.

    Returns ``None`` (never raises on a bad file) when tuning is killed
    via ``REPRO_NO_TUNING``, no table exists, or the cached one is
    unreadable or mismatched: the wrappers' launch rules then pick.
    Without a card, a ``device`` of ``"cuda"`` raises
    (:func:`~repro_torch.core.profile_store.current_fingerprint`).
    """
    return _load_for(current_fingerprint(backend=backend, dtype=dtype,
                                         device=device))


def runner_tuning(runner) -> Optional[str]:
    """The tuning state ``runner`` launches under, as an atlas header
    records it: the digest of its resolved table (auto-loading it now),
    or None under ``REPRO_NO_TUNING``, without a table, or on a backend
    without tuning."""
    if not getattr(runner, "supports_tuning", False) or tuning_disabled():
        return None
    table = runner.tuning_table()
    return None if table is None else table.digest()


def atlas_tuning(fingerprint: HardwareFingerprint) -> Optional[str]:
    """What a sweep's atlas records as its tuning state: the digest of the
    table the ``cuda`` backend auto-loads for ``fingerprint``, or None
    under ``REPRO_NO_TUNING``, without a table, or on another backend."""
    if fingerprint.backend != "cuda":
        return None
    table = _load_for(fingerprint)
    return None if table is None else table.digest()
