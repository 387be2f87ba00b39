"""The port's dry-run layer on a fake process group, on the CPU.

* Per-device FLOPs are counted on the local shards: a batch-sharded
  matrix product on the (16, 16) mesh, forward and weight gradient, costs
  the global count / 16 on each device — the hand count, never the
  global 240.5 GFLOP that ``FlopCounterMode`` reports around DTensors.
* A column-parallel then row-parallel pair on a fake (1, 4) mesh records
  exactly the one all-reduce the layout needs, with its result bytes.
* A vocab-sharded embedding lookup gathers one vocab shard of the table
  over ``data`` (the FSDP gather), never the whole table, and
  reduce-scatters the partial rows into the sequence layout.
* ``Roofline``'s terms, bottleneck, ``model_flops_ratio`` and
  ``roofline_fraction`` equal the reference's on the same inputs with
  explicit peaks.
* The reference test's proxy dense config on a fake (4, 2) mesh traces
  in train, prefill and decode (``tests/test_multidevice.py``'s
  counterparts): compute and memory terms above 0, collectives in train,
  a positive peak, and the state's local bytes equal to what the specs
  say.
* One smoke cell of each family through the CLI on the (16, 16) mesh,
  and a skipped cell reported as the reference reports it.
"""

import json

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch.hlo import Roofline as RefRoofline
from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun, hlo
from repro_torch.models.transformer import ModelConfig


@pytest.fixture
def fake_world():
    made = []

    def make(world):
        dryrun.ensure_fake_world(world)
        made.append(world)

    try:
        yield make
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_per_device_flops_of_a_batch_sharded_matmul(fake_world):
    fake_world(256)
    mesh = init_device_mesh("cpu", (16, 16),
                            mesh_dim_names=("data", "model"))
    m, k, n = 1024, 4096, 14336
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = distribute_tensor(torch.empty(m, k), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(k, n), mesh,
                              [Replicate(), Replicate()]).requires_grad_()
        with hlo.CostRecorder() as rec:
            y = x @ w
            (g,) = torch.autograd.grad((y * y).sum(), [w])
    per_product = 2 * m * k * n // 16        # x's 64 rows on each device
    assert rec.flops == 2 * per_product      # forward + weight gradient
    assert rec.flops != 2 * 2 * m * k * n    # 240.5 GFLOP: the global one
    assert rec.trace == []                   # the gradient stays partial


def test_column_then_row_parallel_records_one_all_reduce(fake_world):
    fake_world(4)
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    b, d, f = 8, 32, 64
    x = distribute_tensor(torch.randn(b, d), mesh, [Replicate()] * 2)
    w1 = distribute_tensor(torch.randn(d, f), mesh, [Replicate(), Shard(1)])
    w2 = distribute_tensor(torch.randn(f, d), mesh, [Replicate(), Shard(0)])
    with hlo.CostRecorder() as rec:
        h = x @ w1                           # column parallel: no comm
        y = h @ w2                           # row parallel: partial sums
        y = y.redistribute(mesh, [Replicate(), Replicate()])
    stats = hlo.collective_stats(rec.trace)
    assert stats.counts == {"all-reduce": 1}
    assert stats.bytes_ == {"all-reduce": b * d * 4}
    assert rec.flops == 2 * b * d * (f // 4) * 2
    assert hlo.top_collectives(rec.trace)[0][:2] == (b * d * 4,
                                                     "all-reduce")


def test_vocab_sharded_embedding_gathers_one_vocab_shard(fake_world):
    from repro_torch.models import layers
    fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    v, d, b, s = 64, 16, 4, 8
    table = layers.Embed(v, d, generator=None, device="cpu",
                         dtype=torch.float32)
    table.w = torch.nn.Parameter(distribute_tensor(
        table.w.detach(), mesh, [Shard(1), Shard(0)]))   # (vocab, embed)
    tokens = distribute_tensor(torch.randint(0, v, (b, s)), mesh,
                               [Shard(0), Replicate()])
    with hlo.CostRecorder() as rec:
        x = layers.embed(table, tokens)
        (g,) = torch.autograd.grad(x.sum(), [table.w])
    assert tuple(x.placements) == (Shard(0), Shard(1))   # batch, sequence
    assert tuple(g.placements) == tuple(table.w.placements)
    stats = hlo.collective_stats(rec.trace)
    assert stats.counts == {"all-gather": 1, "reduce-scatter": 2}
    # the rows of this rank's vocab shard, whole in d; not v * d * 4
    assert stats.bytes_["all-gather"] == v // 4 * d * 4
    assert stats.bytes_["reduce-scatter"] == \
        b // 2 * s // 4 * d * 4 + v // 4 * d // 2 * 4


@pytest.mark.parametrize("terms", [(3e14, 2e11, 1e9), (1e12, 9e12, 1e9),
                                   (1e12, 1e9, 8e12), (0.0, 0.0, 0.0)])
def test_roofline_matches_the_reference(terms):
    flops, nbytes, coll = terms
    peaks = dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=50e9)
    mine = hlo.Roofline(flops, nbytes, coll, chips=256, **peaks)
    ref = RefRoofline(flops, nbytes, coll, chips=256, **peaks)
    for name in ("t_compute", "t_memory", "t_collective", "t_bound",
                 "bottleneck"):
        assert getattr(mine, name) == getattr(ref, name), name
    model_flops = 6 * 8.8e9 * 256 * 4096
    assert mine.model_flops_ratio(model_flops) == \
        ref.model_flops_ratio(model_flops)
    assert mine.roofline_fraction(model_flops) == \
        ref.roofline_fraction(model_flops)
    # the card's data-sheet defaults; the link of a mesh across nodes
    dflt = hlo.Roofline(1.0, 1.0, 1.0, chips=1)
    assert (dflt.peak_flops, dflt.hbm_bw, dflt.link_bw) == \
        (989e12, 3.35e12, 50e9)
    assert hlo.link_bandwidth({"data": 16, "model": 16}) == 50e9
    assert hlo.link_bandwidth({"data": 2, "model": 4}) == 900e9


PROXY = ModelConfig(name="proxy", family="dense", n_layers=2, d_model=256,
                    n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                    vocab=4096, tied_embeddings=True, remat="full")


@pytest.mark.parametrize("kind,seq", [("train", 512), ("prefill", 512),
                                      ("decode", 256)])
def test_proxy_cell_on_a_fake_4x2_mesh(fake_world, kind, seq):
    fake_world(8)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    shape = ShapeSpec(kind[0], seq, 8, kind)
    raw = dryrun.trace_step(PROXY, shape, mesh)
    r = dryrun.cell_result(PROXY, shape, "4x2", {"data": 4, "model": 2},
                           raw)
    assert r["t_compute"] > 0 and r["t_memory"] > 0
    assert r["bytes_per_device"]["peak_est"] > 0
    assert r["bytes_per_device"]["activation_peak"] > 0
    assert r["bytes_per_device"]["state"] == \
        r["bytes_per_device"]["state_from_specs"]
    assert r["link_bw"] == 900e9            # 8 devices: one node
    if kind == "train":
        assert sum(r["collectives"]["counts"].values()) > 0
        assert 0 < r["model_flops_ratio"] < 1   # remat recomputes
    assert r["bottleneck"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("arch,shape", [
    ("glm4-9b", "train_4k"),           # dense
    ("olmoe-1b-7b", "train_4k"),       # moe
    ("mamba2-370m", "decode_32k"),     # ssm
    ("zamba2-1.2b", "prefill_32k"),    # hybrid: the forward
    ("whisper-tiny", "prefill_32k"),   # encdec: the forward
    ("internvl2-76b", "prefill_32k"),  # vlm: the flash prefill
])
def test_cli_smoke_cell_of_each_family(tmp_path, capsys, arch, shape):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--smoke", "--arch", arch, "--shape", shape,
                        "--out", str(out)]) == 0
    assert not dist.is_initialized()
    (r,) = json.loads(out.read_text())
    assert r["mesh"] == "16x16" and r["chips"] == 256
    assert r["flops_per_device"] > 0 and r["t_memory"] > 0
    assert r["bytes_per_device"]["state"] == \
        r["bytes_per_device"]["state_from_specs"]
    assert "[ ok ]" in capsys.readouterr().out


def test_cli_reports_a_skipped_cell(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "yi-9b", "--shape", "long_500k",
                        "--no-depth-correct", "--out", str(out)]) == 0
    (r,) = json.loads(out.read_text())
    assert r["skipped"] and "sub-quadratic" in r["reason"]
    assert "[skip] yi_9b × long_500k × 16x16" in capsys.readouterr().out


def test_dryrun_refuses_a_real_process_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process of its own"):
            dryrun.ensure_fake_world(8)
    finally:
        dist.destroy_process_group()


def test_run_multipod_torch_writes_and_resumes(tmp_path, monkeypatch,
                                              capsys):
    """The script of every cell at (2, 16, 16): each result written as it
    comes, a resume traces only what is missing or failed, a failure
    exits 1 (``run_cell`` stubbed: the traces are the CLI's, above)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "run_multipod_torch.py"
    spec = importlib.util.spec_from_file_location("run_multipod_torch",
                                                  path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    calls = []

    def fake_cell(arch, shape, multi_pod):
        calls.append((arch, shape))
        assert multi_pod
        if (arch, shape) == ("yi_9b", "decode_32k") and len(calls) < 40:
            raise RuntimeError("planted")
        return {"arch": arch.replace("_", "-"), "shape": shape,
                "mesh": "2x16x16", "trace_s": 0.0,
                "bytes_per_device": {"peak_est": 1}}

    monkeypatch.setattr(script, "run_cell", fake_cell)
    out = tmp_path / "multi.json"
    assert script.main(["--out", str(out)]) == 1
    first = json.loads(out.read_text())
    assert len(first) == len(calls) == 40
    assert [r for r in first if "error" in r] == [
        {"arch": "yi_9b", "shape": "decode_32k", "mesh": "2x16x16",
         "error": "RuntimeError: planted", "arch_id": "yi_9b"}]
    assert calls[-1] == ("internvl2_76b", "train_4k")   # the largest last
    assert script.main(["--out", str(out)]) == 0
    assert calls[40:] == [("yi_9b", "decode_32k")]     # only the failed
    assert len(json.loads(out.read_text())) == 40
