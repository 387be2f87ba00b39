"""The port's spans and counters (``repro_torch.runtime.spans``).

On the CPU, where a device mark is the host clock:

* with no recorder, ``region`` hands back the very objects it was given
  and adds no autograd node, and a recorded eager step of a small Mamba2
  (both SSD forms) gives bit for bit the loss and gradients of an
  unrecorded one;
* spans carry their parent and their step; a capture's marks are kept
  apart and read once a replay of them is handed over;
* the train loop records each of its host spans once a step, and the
  caller's hook collects that step's device spans;
* the SSD's backward marks (``ssm.ssd.bwd`` and, inside it, the chunk
  stages') fall inside ``train.backward``, one pair a layer;
* the mode counters count the picks that ``select_ssd_mode`` makes;
* self time is the duration less what the children cover.

Marked ``gpu`` (they skip without a CUDA device; on the card:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_spans.py``):
marks captured around two ``bmm``s read, on replay, the kernels' device
time under ``torch.profiler`` within 5 %; and the captured train step of
the Mamba2 smoke config with a recorder active replays the same kernels
as without one, to the same losses, with its device spans read each step.
This file imports no JAX.
"""

import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import ssm
from repro_torch.runtime import spans
from repro_torch.runtime.spans import Recorder, Span
from repro_torch.train import loop as train_loop
from repro_torch.train import train_step as ts

LOOP_SPANS = ("train.loop.next_batch", "train.loop.copy_batch",
              "train.loop.eager_step", "train.loop.read_metrics",
              "train.loop.on_step")


def _cfg(mode):
    cfg = configs.get_smoke("mamba2_370m")
    return dataclasses.replace(cfg, ssm=cfg.ssm._replace(ssd_mode=mode))


def _batch(cfg, step=0, seq=64):
    return {k: torch.from_numpy(v) for k, v in
            SyntheticLM(cfg.vocab, seq, 2, seed=0).batch_at(step).items()}


def _grads(cfg, recorder=None):
    state = ts.make_train_state(cfg, seed=0, device="cpu")
    if recorder is None:
        return ts._grads(cfg, state, _batch(cfg), 1, torch.bfloat16)
    with recorder:
        recorder.begin_step(0)
        out = ts._grads(cfg, state, _batch(cfg), 1, torch.bfloat16)
        recorder.collect()
    return out


def _by(spans_, name):
    return [s for s in spans_ if s.name == name]


def _inside(inner: Span, outer: Span) -> bool:
    return outer.start_ms <= inner.start_ms <= inner.end_ms <= outer.end_ms


def test_region_without_a_recorder_returns_its_arguments():
    assert spans.active() is None
    x = torch.randn(3, requires_grad=True)
    y = x * 2
    assert spans.region("r", y) is y
    a, b, none = spans.region("r", x, y, None)
    assert a is x and b is y and none is None
    assert spans.region_end("r", y) is y
    assert x.grad_fn is None and y.grad_fn.name() == "MulBackward0"
    with spans.span("nothing") as entered:
        assert entered is None


@pytest.mark.parametrize("mode", ["chunked", "quadratic"])
def test_a_recorded_step_is_bit_identical_to_an_unrecorded_one(mode):
    cfg = _cfg(mode)
    rec = Recorder("cpu")
    (m0, g0), (m1, g1) = _grads(cfg), _grads(cfg, rec)
    assert torch.equal(m0["loss"], m1["loss"])
    assert list(g0) == list(g1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    names = {s.name for s in rec.spans}
    assert {"ssm.ssd", "ssm.ssd.bwd", "train.forward",
            "train.backward"} <= names
    assert ({"ssm.ssd.intra", "ssm.ssd.inter"} <= names) == \
        (mode == "chunked")


def test_spans_carry_their_parent_and_step():
    rec = Recorder("cpu")
    with rec:
        for step in (3, 4):
            spans.begin_step(step)
            with spans.span("outer"):
                with spans.span("inner"):
                    pass
                with spans.span("host_only", device=False):
                    pass
            rec.collect()
    assert spans.active() is None
    for clock, names in (("host", {"outer", "inner", "host_only"}),
                         ("device", {"outer", "inner"})):
        mine = [s for s in rec.spans if s.clock == clock]
        assert sorted(s.step for s in mine) == sorted([3, 4] * len(names))
        ids = {s.id: s for s in mine}
        for s in mine:
            if s.name == "outer":
                assert s.parent is None
            else:
                parent = ids[s.parent]
                assert parent.name == "outer" and parent.step == s.step
                assert _inside(s, parent)
    assert len({s.id for s in rec.spans}) == len(rec.spans)


def test_a_capture_keeps_its_marks_for_the_replays():
    rec = Recorder("cpu")
    with rec:
        rec.begin_step(0)
        with spans.span("warmup"):
            pass
        with spans.capturing() as marks:
            with spans.span("graph"):
                with spans.span("kernel"):
                    pass
        assert [s.name for s in rec.collect()] == ["warmup"]
        rec.begin_step(1)
        spans.replayed(marks)
        first = rec.collect()
        rec.begin_step(2)
        spans.replayed(marks)      # not collected: dropped at the next step
        rec.begin_step(3)
        assert rec.collect() == []
    assert [(s.name, s.step) for s in first] == [("graph", 1), ("kernel", 1)]
    assert first[1].parent == first[0].id and first[0].start_ms == 0.0
    with spans.capturing() as none:
        pass
    assert none == []


def test_the_loop_records_its_host_spans_once_a_step(tmp_path):
    cfg = _cfg("auto")
    rec = Recorder("cpu")
    collected = {}

    def on_step(step, metrics, wall):
        collected[step] = rec.collect()

    with rec:
        train_loop.train(cfg, SyntheticLM(cfg.vocab, 64, 2, seed=0), 3,
                         ckpt_dir=str(tmp_path), save_every=2, warmup=1,
                         device="cpu", log_fn=lambda _: None,
                         on_step=on_step)
    host = [s for s in rec.spans if s.clock == "host"]
    for name in LOOP_SPANS:
        assert sorted(s.step for s in _by(host, name)) == [0, 1, 2], name
    assert sorted(s.step for s in _by(host, "train.loop.save")) == [1, 2]
    assert "train.loop.replay" not in {s.name for s in host}
    ids = {s.id: s for s in host}
    for s in _by(host, "train.step"):
        assert ids[s.parent].name == "train.loop.eager_step"
    for step, got in collected.items():
        assert {s.step for s in got} == {step}
        assert [s.name for s in got if s.parent is None] == ["train.step"]
    summary = rec.summary("device")
    assert summary["train.step"]["steps"] == 3


def test_ssd_backward_marks_fall_inside_train_backward():
    cfg = _cfg("chunked")
    rec = Recorder("cpu")
    with rec:
        rec.begin_step(0)
        ts.train_step(ts.make_train_state(cfg, seed=0, device="cpu"),
                      _batch(cfg), cfg=cfg, peak_lr=1e-3, warmup=1)
        dev = rec.collect()
    ids = {s.id: s for s in dev}
    (backward,), (forward,) = _by(dev, "train.backward"), \
        _by(dev, "train.forward")
    for name, outer, parent in (("ssm.ssd.bwd", backward, "train.backward"),
                                ("ssm.ssd", forward, "train.forward")):
        marks = _by(dev, name)
        assert len(marks) == cfg.n_layers, name
        for s in marks:
            assert _inside(s, outer) and ids[s.parent].name == parent
    for stage in ("ssm.ssd.intra", "ssm.ssd.inter"):
        assert len(_by(dev, stage + ".bwd")) == cfg.n_layers
        for s in _by(dev, stage + ".bwd"):
            assert ids[s.parent].name == "ssm.ssd.bwd"
            assert _inside(s, ids[s.parent])
    # backward runs the stages in reverse: inter's gradient before intra's
    for bwd in _by(dev, "ssm.ssd.bwd"):
        inter, intra = [next(s for s in dev if s.parent == bwd.id
                             and s.name == f"ssm.ssd.{k}.bwd")
                        for k in ("inter", "intra")]
        assert inter.end_ms <= intra.start_ms
    for name in ("train.cast", "train.forward", "train.backward",
                 "train.grad_norm", "adamw.update"):
        (s,) = _by(dev, name)
        assert ids[s.parent].name == "train.step"
    for name, parent in (("adamw.moments", "adamw.update"),
                         ("adamw.apply", "adamw.update"),
                         ("adamw.cast", "adamw.moments"),
                         ("adamw.clip", "adamw.moments")):
        (s,) = _by(dev, name)
        assert ids[s.parent].name == parent


def test_ssd_mode_counters_count_the_picks():
    shapes = [(s, 128, 64, 256, 32) for s in (64, 256, 1024, 2048, 8192)] \
        + [(s, 16, 32, 32, 4) for s in (32, 64, 128, 512)]
    with Recorder("cpu") as rec:
        picks = [ssm.select_ssd_mode(*shape) for shape in shapes]
    assert {"chunked", "quadratic"} == set(picks)
    assert dict(rec.counts) == {f"ssm.ssd.mode.{m}": picks.count(m)
                                for m in set(picks)}
    ssm.select_ssd_mode(*shapes[0])          # no recorder: not counted
    assert sum(rec.counts.values()) == len(shapes)
    cfg = _cfg("auto")
    with Recorder("cpu") as rec:
        _grads(cfg)
    pick = ssm.select_ssd_mode(64, cfg.ssm.d_state, cfg.ssm.head_dim,
                               cfg.ssm.chunk, heads=cfg.ssm.n_heads)
    want = {f"ssm.ssd.mode.{pick}": cfg.n_layers}
    if pick == "chunked":   # each chunked call counts its intra-chunk route
        want["ssm.ssd.intra.plain"] = cfg.n_layers
    assert dict(rec.counts) == want
    with Recorder("cpu") as rec:
        ssm.ssd_chunked(*(torch.zeros(shape) for shape in (
            (1, 64, 4, 16), (1, 64, 4), (4,), (1, 64, 1, 16), (1, 64, 1, 16))),
            chunk=32)
    assert dict(rec.counts) == {"ssm.ssd.intra.plain": 1}


def test_self_time_is_the_duration_less_the_children():
    rec = Recorder("cpu")
    rec.spans = [
        Span(1, "step", None, 0, 0.0, 10.0, "device"),
        Span(2, "a", 1, 0, 1.0, 4.0, "device"),
        Span(3, "b", 1, 0, 3.0, 6.0, "device"),        # overlaps a
        Span(4, "a", 1, 0, 9.0, 12.0, "device"),       # runs past step
        Span(5, "leaf", 2, 0, 1.5, 2.0, "device"),
        Span(6, "step", None, 1, 0.0, 8.0, "device"),
        Span(7, "a", 6, 1, 2.0, 4.0, "device"),
        Span(8, "step", None, 0, 0.0, 5.0, "host"),
    ]
    own = rec.self_ms()
    assert own == {1: 10.0 - 5.0 - 1.0, 2: 2.5, 3: 3.0, 4: 3.0, 5: 0.5,
                   6: 6.0, 7: 2.0}
    assert rec.per_step()[0] == {"step": (10.0, 4.0), "a": (6.0, 5.5),
                                 "b": (3.0, 3.0), "leaf": (0.5, 0.5)}
    summary = rec.summary()
    assert summary["step"] == {"total_ms": 9.0, "self_ms": 5.0, "steps": 2}
    assert summary["leaf"]["steps"] == 1
    assert rec.summary(steps={1})["a"] == {"total_ms": 2.0, "self_ms": 2.0,
                                           "steps": 1}
    assert rec.self_ms("host") == {8: 5.0}
    assert rec.export()["spans"][0] == {
        "id": 1, "name": "step", "parent": None, "step": 0, "start_ms": 0.0,
        "end_ms": 10.0, "clock": "device"}


def test_a_host_span_is_a_profiler_range():
    """Around the block, or empty at its start (``enclose=False``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("around"):
            torch.ones(4).sum()
        with spans.span("start", enclose=False):
            torch.ones(4).sum()
    events = {e.name: e for e in prof.events()
              if e.name.startswith(spans.PREFIX)}
    assert set(events) == {spans.PREFIX + "around", spans.PREFIX + "start"}
    sums = sorted((e for e in prof.events() if e.name == "aten::sum"),
                  key=lambda e: e.time_range.start)
    for name, work, inside in (("around", sums[0], True),
                               ("start", sums[1], False)):
        r = events[spans.PREFIX + name].time_range
        assert (r.start <= work.time_range.start
                and work.time_range.end <= r.end) == inside
        assert r.start <= work.time_range.start


# ------------------------------------------------------------- the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    return torch.device("cuda")


@pytest.mark.gpu
def test_captured_marks_read_the_profilers_device_time(cuda):
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(32, 1024, 1024, device=cuda)
    b = torch.randn(32, 1024, 1024, device=cuda)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    rec = Recorder(cuda)
    with rec:
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            torch.bmm(torch.bmm(a, b), b)
        torch.cuda.synchronize()
        with spans.capturing() as marks, torch.cuda.graph(graph):
            with spans.span("two_bmm"):
                torch.bmm(torch.bmm(a, b), b)
        graph.replay()
        torch.cuda.synchronize()
        steps = range(1, 6)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for step in steps:
                rec.begin_step(step)
                graph.replay()
                spans.replayed(marks)
                assert [s.name for s in rec.collect()] == ["two_bmm"]
    kernels = _device_events(prof)
    assert kernels and len(kernels) % len(steps) == 0
    profiled = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 \
        / len(steps)
    marked = rec.summary("device")["two_bmm"]["total_ms"]
    assert abs(marked - profiled) <= 0.05 * profiled, (marked, profiled)


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(spans.PREFIX)]


def _replay_kernels(compiled):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        compiled()
        torch.cuda.synchronize()
    return sorted(e.name for e in _device_events(prof))


@pytest.mark.gpu
def test_a_recorded_capture_replays_the_same_kernels(cuda):
    cfg = _cfg("auto")
    step = ts.make_train_step(cfg, peak_lr=1e-3, warmup=1, total_steps=4)
    runs = []
    for recorder in (None, Recorder(cuda)):
        state = ts.make_train_state(cfg, seed=0, device=cuda)
        batches = [{k: v.to(cuda) for k, v in _batch(cfg, i).items()}
                   for i in range(3)]
        with recorder if recorder is not None else spans.capturing():
            spans.begin_step(0)
            compiled = ts.compile_train_step(step, state, batches[0])
            losses = [float(compiled.first["loss"])]
            for i, batch in enumerate(batches[1:], 1):
                spans.begin_step(i)
                ts.copy_batch(compiled.batch, batch)
                losses.append(float(compiled()["loss"]))
                if recorder is not None:
                    got = recorder.collect()
                    assert {s.step for s in got} == {i}
                    assert len(_by(got, "ssm.ssd.bwd")) == cfg.n_layers
            kernels = _replay_kernels(compiled)
        runs.append((losses, kernels, compiled.marks))
    (plain, plain_kernels, none), (recorded, kernels, marks) = runs
    assert none == [] and len(marks) > 0
    assert kernels == plain_kernels
    torch.testing.assert_close(recorded, plain, rtol=1e-5, atol=0)
    assert recorder.counts["train.capture.count"] == 1
    assert recorder.counts["train.capture.pool_bytes"] == \
        compiled.pool_bytes
    summary = recorder.summary("device", steps={1, 2})
    parts = sum(summary[n]["total_ms"] for n in (
        "train.cast", "train.forward", "train.backward", "train.grad_norm",
        "adamw.update"))
    assert parts <= summary["train.step"]["total_ms"]
