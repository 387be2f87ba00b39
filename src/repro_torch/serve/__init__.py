"""Serving steps of the port: single-token decode and the generation
loop (``decode``). The plan cache is not ported yet (ROADMAP A6)."""
