"""The reference against the program at smoke size on the CPU, both in
float32: the loss, every leaf's gradient and an AdamW step agree; the SSD
against its sequential recurrence."""

import pytest
import torch

from h100_bench import reference, weights
from h100_bench.reference import common, ssm, train as ref_train
from h100_bench.tests import smoke

CELLS = ["mamba2_370m.train"]


def test_ssd_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    b, s, h, p, groups, n = 2, 48, 4, 8, 2, 5
    f64 = dict(generator=g, dtype=torch.float64)
    x = torch.randn(b, s, h, p, **f64)
    dt = torch.rand(b, s, h, **f64) * 0.5
    a = -torch.rand(h, **f64) * 3
    bm, cm = torch.randn(b, s, groups, n, **f64), \
        torch.randn(b, s, groups, n, **f64)
    y = ssm.ssd(x, dt, a, bm, cm, chunk=16)
    bh, ch = bm.repeat_interleave(2, 2), cm.repeat_interleave(2, 2)
    state = torch.zeros(b, h, n, p, dtype=torch.float64)
    want = []
    for t in range(s):
        state = state * torch.exp(dt[:, t] * a)[..., None, None] + \
            torch.einsum("bhn,bhp->bhnp", bh[:, t] * dt[:, t, :, None],
                         x[:, t])
        want.append(torch.einsum("bhn,bhnp->bhp", ch[:, t], state))
    assert torch.allclose(y, torch.stack(want, 1), atol=1e-12)


@pytest.mark.parametrize("cell", CELLS)
def test_train_step_agrees_with_program(cell):
    from repro_torch.train.train_step import make_train_state, train_step
    f, pc = smoke.files(cell)
    cfg = f["config"]
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
                              opt, checkpoint=False)
    assert float(m["loss"]) == pytest.approx(ref["losses"][0], rel=1e-6)
    first = {n: float(state.opt.mu[n].norm()) / (1 - opt["b1"])
             for n in w}
    change = {n: float((state.params[n] - w[n]).norm()) for n in w}
    assert ref_train.worst_leaf(first, ref["first_grad"], list(w))[0] < 1e-5
    moving = ref_train.moving_leaves(ref["first_grad"])
    assert ref_train.worst_leaf(change, ref["change"], moving)[0] < 1e-4


def test_family_modules_are_found_by_name():
    cfg = {"family": "ssm"}
    assert reference.family(cfg) is ssm
    assert callable(ssm.param_spec) and callable(ssm.forward)


def test_fp8_control_rounds_products():
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(3))
    fp8 = common.Precision("fp8").round(x)
    rel = ((fp8 - x).norm() / x.norm()).item()
    assert 1e-3 < rel < 0.1
    assert torch.equal(common.Precision().round(x), x)
