"""Framework-neutral core of the port: expressions, enumeration, FLOPs,
anomaly classification, fingerprints, execution backends and the sweep;
the planner (the paper's contribution as a runtime feature) and the
launch tuner's search space and table."""

from .backends import (BlasBackend, CacheFlusher, NumpyBackend,
                       reference_execute)
from .planner import (
    Plan,
    Planner,
    default_planner,
    plan,
    reset_default_planner,
    resolve_profile,
)
from .tuning import (
    ENV_NO_TUNING,
    TUNABLE_KINDS,
    TUNING_SCHEMA_VERSION,
    PruneReport,
    RejectedCandidate,
    TunedEntry,
    TuningTable,
    candidate_configs,
    config_key,
    load_default_tuning_table,
    load_tuning_table,
    prune_candidates,
    save_tuning_table,
    tuning_path,
)

__all__ = [
    "BlasBackend", "CacheFlusher", "ENV_NO_TUNING", "NumpyBackend",
    "Plan", "Planner", "PruneReport", "RejectedCandidate",
    "TUNABLE_KINDS", "TUNING_SCHEMA_VERSION", "TunedEntry", "TuningTable",
    "candidate_configs", "config_key", "default_planner",
    "load_default_tuning_table", "load_tuning_table", "plan",
    "prune_candidates", "reference_execute", "reset_default_planner",
    "resolve_profile",
    "save_tuning_table", "tuning_path",
]
