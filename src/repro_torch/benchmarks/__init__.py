"""Drivers of the paper's three experiments on the port's backends.

Run as ``python -m repro_torch.benchmarks.experiment1`` (and ``2``,
``3``); each prints ``name,us_per_call,derived`` rows, with the
measuring backend's fingerprint in ``derived``. Configured through
:mod:`repro_torch.benchmarks.common`'s environment variables.
"""
