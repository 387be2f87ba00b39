"""The ``hybrid`` family's pieces on the CPU: the cell's files load and
name the published widths, the reference agrees with the program at the
published preset's smoke size, the roofline's counts against hand
reckonings, the shared block's two readers on synthetic records, and a
traced run of the cell reads the block's spans and counter."""

import math

import pytest
import torch

from h100_bench import harness, readers, reference, roofline, weights
from h100_bench.reference import hybrid as ref_hybrid, train as ref_train
from h100_bench.roofline import hybrid, ssm
from h100_bench.tests import smoke
from h100_bench.tests.test_h100_readers import record, spans, trace

CELL = "zamba2_1p2b.train"
FILES = harness.cell_files(CELL)
ZAMBA2 = FILES["config"]
H100 = "NVIDIA H100 80GB HBM3"


def test_the_cells_files_load_at_the_published_widths():
    assert FILES["mix"]["generator"] == "train_loop"
    assert FILES["mix"]["params"]["batch"] == 1
    assert FILES["mix"]["params"]["peak_lr"] == 3e-5
    assert set(FILES["cell"]["limits"]) == {
        "grad_gap_median", "update_gap_median", "update_gap"}
    pc = harness.port_config(ZAMBA2)      # every key of port.same checked
    assert pc.shared_block == "published" and pc.ssm.chunk == 256
    sh = ZAMBA2["shared"]
    assert (ZAMBA2["n_layers"], ZAMBA2["d_model"], ZAMBA2["ssm"]["d_inner"],
            ZAMBA2["ssm"]["n_heads"], ZAMBA2["ssm"]["d_state"]) == \
        (38, 2048, 4096, 64, 64)
    assert (sh["attention_in"], sh["n_heads"], sh["head_dim"], sh["d_ff"],
            sh["adapter_rank"], sh["scale"]) == (4096, 32, 128, 8192, 128,
                                                 0.125)
    assert sh["hybrid_layer_ids"] == [6, 12, 18, 24, 30, 36]
    assert ZAMBA2["reduced"] == ["norm_eps"]
    assert {"hybrid_layer_ids", "use_shared_attention_adapter",
            "chunk"} <= set(ZAMBA2["assumed"])
    spec = reference.family(ZAMBA2).param_spec(ZAMBA2)
    assert sum(math.prod(s) for _, s, _ in spec) == ZAMBA2["parameters"]
    assert reference.family(ZAMBA2) is ref_hybrid
    assert roofline.family(ZAMBA2) is hybrid


def test_the_reference_agrees_with_the_program():
    """One AdamW step in float32 at the published preset's smoke size:
    the loss, every leaf's first gradient and change."""
    from repro_torch.train.train_step import make_train_state, train_step
    f, pc = smoke.files(CELL)
    cfg = f["config"]
    assert pc.shared_block == "published" and cfg["shared"]["head_dim"] == 32
    w = weights.make(reference.family(cfg).param_spec(cfg), 5, "cpu")
    state = make_train_state(pc, device="cpu")
    weights.load(state.params, w)
    tok = torch.randint(0, cfg["vocab"], (2, 65),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    opt = dict(cfg["optimizer"], peak_lr=1e-3, warmup=0, total_steps=1000)
    state, m = train_step(state, batch, cfg=pc, peak_lr=1e-3, warmup=0,
                          total_steps=1000, compute_dtype=torch.float32)
    ref = ref_train.run_steps(cfg, w, [(batch["tokens"], batch["labels"])],
                              opt, checkpoint=True)
    assert float(m["loss"]) == pytest.approx(ref["losses"][0], rel=1e-6)
    first = {n: float(state.opt.mu[n].norm()) / (1 - opt["b1"])
             for n in w}
    change = {n: float((state.params[n] - w[n]).norm()) for n in w}
    assert ref_train.worst_leaf(first, ref["first_grad"], list(w))[0] < 1e-5
    moving = ref_train.moving_leaves(ref["first_grad"])
    assert any(n.startswith("applications.") for n in moving)
    assert ref_train.worst_leaf(change, ref["change"], moving)[0] < 1e-4


def test_parameter_count():
    # Mamba2 part: embedding 32,000 x 2,048 = 65,536,000; a layer:
    # in_proj 2,048 x 8,384 = 17,170,432, out_proj 8,388,608, conv 4 x
    # 4,224 + 4,224 = 21,120, per-head vectors 192, gated norm 4,096,
    # pre-norm 2,048: 25,586,496; 38 of them 972,286,848; final norm 2,048.
    # The memory block: norms 4,096 + 2,048, q, k, v 3 x 4,096 x 4,096 =
    # 50,331,648, o 8,388,608, gate_up 33,554,432, down 16,777,216:
    # 109,058,048. An application: linear 4,194,304, gate_up's adapter
    # 128 x 18,432 = 2,359,296, q's, k's and v's 3 x 128 x 8,192 =
    # 3,145,728: 9,699,328, six of them 58,195,968.
    assert ssm.param_count(ZAMBA2) == 1_037_824_896
    assert roofline.param_count(ZAMBA2) == 1_037_824_896 + 109_058_048 \
        + 58_195_968 == 1_205_078_912


def test_train_flops_per_token():
    # a Mamba2 layer: in_proj 34,340,864, out_proj 16,777,216, conv
    # 33,792, the SSD at chunk 256 64 x (2 x 256 x 128 + 4 x 64 x 64) =
    # 5,242,880: 56,394,752, 38 of them 2,143,000,576. An application:
    # 2 x (q, k, v 50,331,648 + o 8,388,608 + MLP 50,331,648 + linear
    # 4,194,304 + adapters 5,505,024) = 237,502,464 and causal attention
    # 2 x 32 x 128 x 2,049 = 16,785,408: 254,287,872, six of them
    # 1,525,727,232. Head 2 x 2,048 x 32,000 = 131,072,000.
    assert hybrid.shared_flops_per_token(ZAMBA2, 2048) == 254_287_872
    fwd = roofline.forward_flops_per_token(ZAMBA2, 2048)
    assert fwd == 2_143_000_576 + 1_525_727_232 + 131_072_000
    assert roofline.train_step_flops(ZAMBA2, 1, 2048) == 3 * fwd * 2048


def test_ssd_chunk_work_at_the_cells_shape():
    # B 1, nc 8, Q 256, H 64, P 64, G 1, N 64: the triangle 32,896; C·Bᵀ
    # 33,685,504, the x products 2,155,872,256, the states 1,073,741,824
    # FLOPs, each three times. Bytes: x 8,388,608 values, B and C 131,072
    # each, rows 131,072, states 2,097,152: forward 60,817,408, backward
    # 113,246,208
    flops, nbytes = ssm.ssd_chunk_work(ZAMBA2, 1, 2048)
    assert flops == 9_789_898_752
    assert nbytes == 174_063_616
    assert nbytes / 3.35e12 > flops / 989e12      # the bytes bind


def hybrid_record(**over):
    rec = record(config=ZAMBA2, params=FILES["mix"]["params"],
                 device_name=H100)
    rec["spans"]["device"].update(spans(**{
        "hybrid.shared": (37.16, 1.15), "hybrid.shared.bwd": (64.25, 2.65),
        "hybrid.shared.attn": (32.81, 32.81),
        "hybrid.shared.attn.bwd": (55.18, 55.18)}))
    rec.update(over)
    return rec


def read(metric, rec):
    return harness.load_reader(metric)(rec)


@pytest.mark.parametrize("metric,want,backward", [
    ("shared_block_device_ms", 37.16 + 64.25, "hybrid.shared.bwd"),
    ("shared_attention_device_ms", 32.81 + 55.18, "hybrid.shared.attn.bwd")])
def test_shared_block_readers(metric, want, backward):
    assert read(metric, hybrid_record()) == pytest.approx(want)
    assert read(metric, record()) is None               # a Mamba2 run
    no_spans = hybrid_record()
    del no_spans["spans"]
    assert read(metric, no_spans) is None
    assert read(metric, hybrid_record(device_name="cpu")) is None
    half = hybrid_record()
    del half["spans"]["device"][backward]
    assert read(metric, half) is None


def test_ssd_chunk_roofline_reads_the_cells_layers():
    # 38 layers of 174,063,616 bytes at 3.35 TB/s against 20 ms a step
    rec = hybrid_record(trace=trace(kernel_ms=20.0),
                        counts={"ssm.ssd.mode.chunked": 76})
    assert read("ssd_chunk_roofline", rec) == pytest.approx(
        100 * 38 * 174_063_616 / 3.35e12 / 20e-3)


def test_a_traced_run_reads_the_shared_blocks_spans_and_counter():
    f, pc = smoke.files(CELL, **smoke.TRAIN)
    line = harness.run_cell(CELL, 2 ** 31 + 23, 4.0, True, device="cpu",
                            files=f, port_cfg=pc)
    # the check's numbers are read, not judged: at this size bf16 moves
    # them past the limits set on the card at the published widths
    assert set(line["checks"]) == set(FILES["cell"]["limits"])
    assert all(math.isfinite(c["value"]) for c in line["checks"].values())
    detail = line["detail"]
    passes = f["mix"]["params"]["check_steps"] + line["attempted"]
    apps = len(f["config"]["shared"]["hybrid_layer_ids"])
    assert apps == 2
    assert detail["counts"]["hybrid.shared.applications"] == apps * passes
    device = detail["spans"]["device"]
    for name in ("hybrid.shared", "hybrid.shared.attn", "hybrid.shared.mlp"):
        for sfx in ("", ".bwd"):
            total, own = device[name + sfx]
            assert total > 0 and -1e-6 <= own <= total + 1e-6
    # no device metric from the CPU's clocks
    assert "shared_block_device_ms" not in line["metrics"]
    assert readers.span_ms({"spans": detail}, "hybrid.shared") is None
