"""The spans and the counter of the published Zamba2 shared block
(``models.hybrid``, ``shared_block="published"``), on the CPU, where a
device mark is the host clock:

* every application of the block marks ``hybrid.shared`` around
  ``hybrid.shared.attn`` and ``hybrid.shared.mlp`` inside
  ``train.forward``, and their ``.bwd`` regions inside
  ``train.backward``, once an application;
* ``hybrid.shared.applications`` counts the applications a pass of
  Python makes;
* with no recorder the regions add no autograd node, and a recorded step
  gives bit for bit the loss and gradients of an unrecorded one.

This file imports no JAX.
"""

import torch

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import api, hybrid
from repro_torch.runtime.spans import Recorder
from repro_torch.train import train_step as ts

NAMES = ("hybrid.shared", "hybrid.shared.attn", "hybrid.shared.mlp")


def _cfg():
    """2 applications (before layers 2 and 4) of one memory block."""
    return configs.get_smoke("zamba2_1p2b_published")


def _batch(cfg, step=0):
    return {k: torch.from_numpy(v) for k, v in
            SyntheticLM(cfg.vocab, 32, 2, seed=0).batch_at(step).items()}


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


def _inside(inner, outer) -> bool:
    return outer.start_ms <= inner.start_ms <= inner.end_ms <= outer.end_ms


def test_every_application_marks_its_regions():
    cfg = _cfg()
    n = hybrid.n_shared_applications(cfg)
    assert n == 2
    rec = Recorder("cpu")
    with rec:
        rec.begin_step(0)
        ts.train_step(ts.make_train_state(cfg, seed=0, device="cpu"),
                      _batch(cfg), cfg=cfg, peak_lr=1e-3, warmup=1)
        dev = rec.collect()
    ids = {s.id: s for s in dev}
    (forward,), (backward,) = _by(dev, "train.forward"), \
        _by(dev, "train.backward")
    for suffix, outer in (("", forward), (".bwd", backward)):
        blocks = _by(dev, "hybrid.shared" + suffix)
        assert len(blocks) == n
        for s in blocks:
            assert _inside(s, outer) and ids[s.parent] is outer
        for part in ("attn", "mlp"):
            marks = _by(dev, f"hybrid.shared.{part}{suffix}")
            assert len(marks) == n
            for s in marks:
                parent = ids[s.parent]
                assert parent.name == "hybrid.shared" + suffix
                assert _inside(s, parent)
    # the backward runs an application's MLP before its attention
    for block in _by(dev, "hybrid.shared.bwd"):
        mlp, attn = [next(s for s in dev if s.parent == block.id
                          and s.name == f"hybrid.shared.{k}.bwd")
                     for k in ("mlp", "attn")]
        assert mlp.end_ms <= attn.start_ms
    assert rec.counts["hybrid.shared.applications"] == n
    picks = rec.counts.get("ssm.ssd.mode.chunked", 0) + \
        rec.counts.get("ssm.ssd.mode.quadratic", 0)
    assert picks == cfg.n_layers


def test_the_counter_counts_each_pass_of_python():
    cfg = _cfg()
    model = api.init(cfg, device="cpu")
    batch = _batch(cfg)
    with torch.no_grad(), Recorder("cpu") as rec:
        for _ in range(3):
            api.forward_train(model, cfg, batch)
    assert rec.counts["hybrid.shared.applications"] == 3 * 2
    with torch.no_grad():
        api.forward_train(model, cfg, batch)     # no recorder: not counted
    assert rec.counts["hybrid.shared.applications"] == 6


def _node_names(loss):
    seen, todo, names = set(), [loss.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_without_a_recorder_the_graph_and_values_are_the_same():
    cfg = _cfg()
    model = api.init(cfg, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    loss, _ = api.loss_fn(model, cfg, _batch(cfg))
    plain = _node_names(loss)
    assert not [n for n in plain if "_Enter" in n or "_Exit" in n]
    with Recorder("cpu"):
        loss2, _ = api.loss_fn(model, cfg, _batch(cfg))
    marked = _node_names(loss2)
    # each application opens and closes three regions (and each SSD its own)
    assert sum("_Enter" in n for n in marked) >= 3 * 2
    assert sum("_Exit" in n for n in marked) >= 3 * 2
    assert torch.equal(loss.detach(), loss2.detach())
    rec = Recorder("cpu")
    (m0, g0), (m1, g1) = _grads(cfg), _grads(cfg, rec)
    assert torch.equal(m0["loss"], m1["loss"])
    assert list(g0) == list(g1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert {s.name for s in rec.spans} >= {n + sfx for n in NAMES
                                           for sfx in ("", ".bwd")}
