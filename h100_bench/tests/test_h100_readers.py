"""The per-layer readers of the program's spans and counters, and of
the fused SSD kernel's roofline share, on synthetic records: each reads
what the record holds, and nothing (None) where it holds no spans, no
counters or no kernel of its own."""

import pytest

from h100_bench import harness, readers
from h100_bench.trace import TraceSummary

H100 = "NVIDIA H100 80GB HBM3"
CELL = "mamba2_370m.train"
FILES = harness.cell_files(CELL)
KERNEL_MS = 27.62      # the fused kernels' device time a step


def spans(**by):
    return {name: {"total_ms": t, "self_ms": s, "steps": 8}
            for name, (t, s) in by.items()}


def trace(kernel_ms=KERNEL_MS, steps=2, name="void repro_ssd::bwd_dx_kernel"):
    ns = int(kernel_ms * 1e6)
    ivs = [(1000 + i * 2 * ns, 1000 + i * 2 * ns + ns, name)
           for i in range(steps)]
    ivs.append((500, 900, "void at::native::elementwise_kernel"))
    return TraceSummary(ivs, [(0, "after_on_step"), (4 * steps * ns, "end")])


def record(**over):
    rec = {"kind": "train", "device_name": H100,
           "config": FILES["config"], "params": FILES["mix"]["params"],
           "trace": trace(), "trace_steps": 2,
           "spans": {
               "device": spans(**{"train.step": (250.08, 0.04),
                                  "ssm.ssd": (27.98, 0.85),
                                  "ssm.ssd.bwd": (57.10, 0.84),
                                  "adamw.update": (20.78, 0.0)}),
               "host": spans(**{"train.capture.warmup": (2400.0, 2400.0),
                                "train.capture.record": (3100.0, 3100.0)})},
           "counts": {"ssm.ssd.mode.chunked": 96,
                      "ssm.ssd.intra.kernel": 96}}
    rec.update(over)
    return rec


def read(metric, rec):
    return harness.load_reader(metric)(rec)


SPAN_METRICS = [("step_device_ms", 250.08), ("ssd_device_ms", 27.98 + 57.10),
                ("adamw_update_device_ms", 20.78), ("capture_s", 5.5)]


@pytest.mark.parametrize("metric,want", SPAN_METRICS)
def test_span_metric_reads_the_record(metric, want):
    assert read(metric, record()) == pytest.approx(want)


@pytest.mark.parametrize("metric", [m for m, _ in SPAN_METRICS])
def test_span_metric_is_none_without_spans(metric):
    rec = record()
    del rec["spans"]
    assert read(metric, rec) is None
    assert read(metric, record(spans={"device": {}, "host": {}})) is None


@pytest.mark.parametrize("metric", ["step_device_ms", "ssd_device_ms",
                                    "adamw_update_device_ms"])
def test_device_spans_off_a_card_are_not_read(metric):
    # on the CPU a device mark is the host clock
    assert read(metric, record(device_name="cpu")) is None


def test_a_sum_of_spans_needs_every_name():
    rec = record()
    del rec["spans"]["device"]["ssm.ssd.bwd"]
    assert read("ssd_device_ms", rec) is None
    assert readers.span_ms(record(), "ssm.ssd", own=True) == 0.85


def test_count():
    assert readers.count(record(), "ssm.ssd.mode.chunked") == 96
    assert readers.count(record(), "ssm.ssd.mode.quadratic") == 0
    assert readers.count(record(counts=None), "ssm.ssd.mode.chunked") is None


def test_ssd_chunk_roofline_reads_the_kernels_against_their_bound():
    # 48 layers of 195,559,424 bytes at 3.35 TB/s: 2.802 ms a step,
    # against 27.62 ms of the kernels a step
    assert read("ssd_chunk_roofline", record()) == pytest.approx(
        100 * 48 * 195_559_424 / 3.35e12 / (KERNEL_MS * 1e-3))


def test_ssd_chunk_roofline_counts_the_chunked_layers_only():
    half = record(counts={"ssm.ssd.mode.chunked": 48,
                          "ssm.ssd.mode.quadratic": 48})
    assert read("ssd_chunk_roofline", half) == pytest.approx(
        read("ssd_chunk_roofline", record()) / 2)


@pytest.mark.parametrize("over", [
    {"trace": trace(name="void at::native::vectorized_elementwise_kernel")},
    {"trace": None}, {"counts": None}, {"counts": {}},
    {"counts": {"ssm.ssd.mode.quadratic": 96}}, {"device_name": "cpu"},
    {"trace_steps": 0}])
def test_ssd_chunk_roofline_is_none_with_nothing_to_read(over):
    assert read("ssd_chunk_roofline", record(**over)) is None
