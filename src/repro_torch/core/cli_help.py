"""Registry-generated ``--help`` epilogs for the port's CLIs.

The port's counterpart of the reference package's ``core/cli_help.py``:
the listings are generated from the discriminant registry, the analysis
rule registry and the execution-backend registry when a parser is built,
so the help text can never drift from what the registries accept.
"""

from __future__ import annotations


def _first_doc_line(obj: object) -> str:
    doc = (getattr(obj, "__doc__", None) or "").strip()
    return doc.splitlines()[0].rstrip(".") if doc else ""


def discriminants_epilog() -> str:
    """One line per registered selection policy, capability-flagged."""
    from .discriminants import get_discriminant, registered_discriminants

    lines = ["registered discriminants (repro_torch.core.discriminants):"]
    for name in registered_discriminants():
        d = get_discriminant(name)
        flags = []
        if getattr(d, "requires_profile", False):
            flags.append("profile")
        if getattr(d, "requires_measurement", False):
            flags.append("measures")
        tag = f" [{', '.join(flags)}]" if flags else ""
        lines.append(f"  {name:<10} {_first_doc_line(type(d))}{tag}")
    return "\n".join(lines)


def analysis_rules_epilog() -> str:
    """One line per registered static-analysis rule, severity-flagged."""
    from .analysis import RULES

    lines = ["static analysis rules (repro_torch.core.analysis; "
             "python -m repro_torch.core.analysis):"]
    for rule_id in sorted(RULES):
        rule = RULES[rule_id]
        lines.append(f"  {rule_id:<18} [{rule.severity}] {rule.summary}")
    return "\n".join(lines)


def backends_epilog() -> str:
    """One line per registered execution backend + its fingerprint dtype."""
    from .backends import (get_backend_class, register_torch_backends,
                           registered_backends)

    register_torch_backends()
    lines = ["registered execution backends (repro_torch.core.backends):"]
    for name in registered_backends():
        cls = get_backend_class(name)
        lines.append(f"  {name:<8} {_first_doc_line(cls)} "
                     f"[dtype={cls.default_dtype}]")
    return "\n".join(lines)
