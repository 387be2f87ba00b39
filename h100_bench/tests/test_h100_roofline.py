"""The roofline's counts against hand reckonings."""

import math

from h100_bench import harness, reference, roofline
from h100_bench.roofline import ssm

MAMBA2 = harness.read_json(harness.BENCH_DIR / "configs" / "mamba2_370m.json")


def test_family_modules_are_found_by_name():
    assert roofline.family(MAMBA2) is ssm


def test_parameter_count():
    # Mamba2-370M: embedding 50,304 x 1,024 = 51,511,296; a layer:
    # in_proj 1,024 x 4,384 = 4,489,216, out_proj 2,048 x 1,024 =
    # 2,097,152, conv 4 x 2,304 + 2,304 = 11,520, three per-head vectors
    # 96, gated norm 2,048, pre-norm 1,024: 6,601,056; 48 of them
    # 316,850,688; final norm 1,024.
    assert roofline.param_count(MAMBA2) == 368_363_008


def test_parameter_count_is_the_models():
    spec = reference.family(MAMBA2).param_spec(MAMBA2)
    assert roofline.param_count(MAMBA2) == sum(
        math.prod(shape) for _, shape, _ in spec)


def test_train_flops_per_token():
    # Mamba2 forward a token: a layer in_proj 2 x 1,024 x 4,384 =
    # 8,978,432, out_proj 4,194,304, conv 2 x 4 x 2,304 = 18,432, the
    # SSD at chunk 256: 32 x (2 x 256 x 192 + 4 x 128 x 64) = 4,194,304;
    # 48 layers 834,502,656; head 2 x 1,024 x 50,277 = 102,967,296.
    fwd = roofline.forward_flops_per_token(MAMBA2, 2048)
    assert fwd == 937_469_952
    assert roofline.train_step_flops(MAMBA2, 2, 2048) == 3 * fwd * 4096


def test_peaks_are_the_data_sheets():
    h100 = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert h100 == {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
    assert roofline.peaks("cpu") is None


def test_ssd_chunk_work_at_the_cells_shape():
    # one layer at B 2, nc 8, Q 256, H 32, P 64, G 1, N 128: the triangle
    # 32,896; C·Bᵀ 134,742,016, the x products 2,155,872,256, the states
    # 2,147,483,648 FLOPs, each three times (forward and backward):
    # 13.31 GFLOP. Bytes: x 8,388,608 values, B and C 524,288 each, rows
    # 131,072, states 4,194,304: forward 70,778,880, backward 124,780,544
    flops, nbytes = ssm.ssd_chunk_work(MAMBA2, 2, 2048)
    assert flops == 13_314_293_760
    assert nbytes == 195_559_424
    assert nbytes / 3.35e12 > flops / 989e12      # the bytes bound it
