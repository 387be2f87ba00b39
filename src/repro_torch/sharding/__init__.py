"""Sharding policy: logical-axis rules → specs and DTensor placements
(DP/TP/EP/FSDP), and the activation-sharding context the models read."""

from .rules import (
    DEFAULT_RULES,
    ZERO1_PARAM_RULES,
    batch_spec,
    params_specs,
    pick_param_policy,
    placements_for,
    replicated,
    rules_for,
    shardings_of,
    spec_for,
)

__all__ = ["DEFAULT_RULES", "ZERO1_PARAM_RULES", "batch_spec",
           "params_specs", "pick_param_policy", "placements_for",
           "replicated", "rules_for", "shardings_of", "spec_for"]
