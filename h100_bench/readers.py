"""What the per-layer readers (``metrics/<metric>.py``) share: the
program's spans and counters, and a kernel's share of its roofline, out
of a run's record. Each returns None where the record has nothing to
read, and the harness then leaves the metric out of the line.

A traced run's record holds, besides the profiler's ``trace``:

* ``spans`` — ``{"device": summary, "host": summary}``, each
  ``repro_torch.runtime.spans.Recorder.summary``'s ``{name: {"total_ms",
  "self_ms", "steps"}}``: medians a step, the device spans' over the
  window steps read after the profiler's window, the host spans' over
  every step in which each appears (the capture's, once, in set-up);
* ``counts`` — the recorder's counters, summed over the run.
"""

from __future__ import annotations

from typing import Optional

from h100_bench import roofline


def span_ms(rec, *names: str, own: bool = False,
            clock: str = "device") -> Optional[float]:
    """The sum of the ``names``' median total (``own``: self) ms a step,
    on ``clock``; None where a name was not recorded, or where device
    spans were read off a card (on the CPU a device mark is the host
    clock)."""
    summary = (rec.get("spans") or {}).get(clock) or {}
    if not names or any(n not in summary for n in names) or \
            (clock == "device" and rec.get("device_name", "cpu") == "cpu"):
        return None
    key = "self_ms" if own else "total_ms"
    return sum(summary[n][key] for n in names)


def count(rec, name: str) -> Optional[int]:
    """Counter ``name`` over the run; None where no counter was kept."""
    counts = rec.get("counts")
    return None if counts is None else counts.get(name, 0)


def kernel_share(rec, contains: str, flops: float, nbytes: float
                 ) -> Optional[float]:
    """The least time a step's ``flops`` and ``nbytes`` take on the card
    (the larger of flops over the bf16 peak and bytes over the HBM
    peak), times the traced steps, over the device time of the kernels
    whose name holds ``contains`` in the traced window, in percent."""
    peak = roofline.peaks(rec.get("device_name", ""))
    t, steps = rec.get("trace"), rec.get("trace_steps")
    if peak is None or t is None or not steps:
        return None
    spent = t.device_s(contains=contains)
    if spent <= 0:
        return None
    least = max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes_per_s"])
    return 100 * least * steps / spent
