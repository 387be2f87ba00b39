"""``attention_train_roofline`` on synthetic records: training's
attention kernels against their bound, the applications scaled by the
kernels' share of the calls, and nothing (None) where the record holds no
such kernel or no counter."""

import pytest

from h100_bench import harness
from h100_bench.tests.test_h100_readers import read, record, trace

ZAMBA = harness.cell_files("zamba2_1p2b.train")
ATTN_MS = 8.0          # training's attention kernels' device time a step


def zamba_record(**over):
    """A traced ``zamba2_1p2b.train`` record whose step spends ATTN_MS in
    training's attention kernels, the 12 calls of a run on the kernels."""
    rec = record(config=ZAMBA["config"], params=ZAMBA["mix"]["params"],
                 trace=trace(ATTN_MS, name="void repro_flash_train::"
                                           "dkdv_kernel<128>"),
                 counts={"attention.train.kernel": 12,
                         "attention.train.plain": 0})
    rec.update(over)
    return rec


def test_attention_train_roofline_reads_the_kernels_against_their_bound():
    # one application: 12·32·128·(2048·2049/2) = 103,129,546,752 FLOPs at
    # 989 TFLOP/s (the bytes, 134,479,872, take less); six a step
    flops = 12 * 32 * 128 * 2048 * 2049 // 2
    assert flops == 103_129_546_752
    assert read("attention_train_roofline", zamba_record()) == pytest.approx(
        100 * 6 * flops / 989e12 / (ATTN_MS * 1e-3))


def test_attention_train_roofline_scales_by_the_kernels_share_of_calls():
    third = zamba_record(counts={"attention.train.kernel": 4,
                                 "attention.train.plain": 8})
    assert read("attention_train_roofline", third) == pytest.approx(
        read("attention_train_roofline", zamba_record()) / 3)


@pytest.mark.parametrize("over", [
    {"trace": trace(name="void repro_ssd::bwd_dx_kernel")},
    {"trace": None}, {"counts": None}, {"counts": {}},
    {"counts": {"attention.train.plain": 12}}, {"device_name": "cpu"},
    {"trace_steps": 0}])
def test_attention_train_roofline_is_none_with_nothing_to_read(over):
    assert read("attention_train_roofline", zamba_record(**over)) is None


def test_attention_train_roofline_is_none_in_the_mamba2_cell():
    # no attention: no counter, whatever the trace holds
    assert read("attention_train_roofline", record()) is None
