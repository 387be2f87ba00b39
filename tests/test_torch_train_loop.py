"""The port's train step, data pipeline and training loop against the JAX
package's, on the CPU.

``train_step`` runs 3 steps of the mamba2 and zamba2 smoke configs from
one state (the reference's weights and optimizer state carried by
``repro_torch.models.convert``) on the same ``SyntheticLM`` batches, with
AdamW and with Muon, in float32 and in bf16, at peak lr 1e-3 from step
0, and is held against the reference's after the first and the third
step. A parameter is compared through its update: the distance to the
reference's over the reference's own update, ‖port − ref‖ / ‖ref −
start‖, per leaf and over all leaves. Adam's first step divides each
gradient by its own size, so a gradient that float32 noise flips near 0
moves its parameter by a whole update; bf16 forward passes round in
other places in the two libraries, and Muon's Newton–Schulz runs in bf16
in both (``tests/test_torch_optim.py``). Each limit is 3× the worst of
these 8 runs, measured on this CPU (in brackets):

* float32, AdamW: loss and grad norm at rtol 1e-5 [6.2e-7]; μ and ν per
  leaf ‖port − ref‖ / ‖ref‖ ≤ 2e-4 [6.66e-5] and over all leaves
  ≤ 3.7e-5 [1.22e-5]; params per leaf ≤ 6.5e-3 [2.14e-3, zamba2's
  zero-initialised ``conv_b``] and over all leaves ≤ 3e-4 [1.01e-4];
* float32, Muon: loss rtol 1e-4 [3.08e-5], grad norm 2.5e-3 [7.37e-4],
  μ, ν and the momentum over all leaves ≤ 0.014 [4.60e-3], params over
  all leaves ≤ 0.04 [0.0132];
* bf16: loss rtol 1.2e-4 [3.87e-5], grad norm 1.1e-2 [3.67e-3], μ, ν
  (and Muon's momentum) over all leaves ≤ 0.19 with AdamW [0.0625] and
  ≤ 0.12 with Muon [0.0406] — the gradients the moments hold agree to a
  few percent — and params over all leaves ≤ 0.62 [0.206, the first
  step's flipped signs].

``accum_steps=2`` over the same batch is held against one step of the
whole batch, and against the reference's accumulation.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.data import pipeline as jpipeline
from repro.train import train_step as jts
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.optim import convert as optim_convert
from repro_torch.runtime.supervisor import RestartPolicy, Supervisor
from repro_torch.train import loop as train_loop
from repro_torch.train import train_step as ts

#: (loss rtol, grad norm rtol, params over all leaves, params per leaf,
#: μ and ν per leaf, μ, ν and Muon's momentum over all leaves); None: not
#: held (see the module docstring).
LIMITS = {
    ("float32", "adamw"): (1e-5, 1e-5, 3e-4, 6.5e-3, 2e-4, 3.7e-5),
    ("float32", "muon"): (1e-4, 2.5e-3, 0.04, None, None, 0.014),
    ("bfloat16", "adamw"): (1.2e-4, 1.1e-2, 0.62, None, None, 0.19),
    ("bfloat16", "muon"): (1.2e-4, 1.1e-2, 0.62, None, None, 0.12),
}
STEP = dict(peak_lr=1e-3, warmup=0, total_steps=10)


def _np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree,
                        is_leaf=lambda x: x is None)


@functools.lru_cache(maxsize=None)
def _reference_start(arch, optimizer):
    state, _ = jts.make_train_state(jax.random.PRNGKey(0), jget_smoke(arch),
                                    optimizer=optimizer)
    return state


def _port_state(arch, optimizer):
    cfg = configs.get_smoke(arch)
    jstate = _reference_start(arch, optimizer)
    model = convert.from_reference_params(_np_tree(jstate.params), cfg,
                                          device="cpu")
    opt = optim_convert.from_reference_optimizer(_np_tree(jstate.opt), cfg,
                                                 device="cpu")
    return ts.TrainState(params=dict(model.named_parameters()), opt=opt,
                         step=torch.zeros((), dtype=torch.int32),
                         model=model)


def _reference_flat(tree, cfg):
    return {n: torch.from_numpy(np.array(v)) for n, v in
            convert._reference_state(_np_tree(tree), cfg).items()}


def _moments(opt):
    return opt if hasattr(opt, "mu") else opt.adamw


def _state_distance(mine, ref):
    """‖mine − ref‖ / ‖ref‖ over every leaf ``ref`` holds."""
    names = [n for n in ref if ref[n] is not None]
    num = sum(float((mine[n] - ref[n]).norm()) ** 2 for n in names)
    return (num / sum(float(ref[n].norm()) ** 2 for n in names)) ** 0.5


def _update_distance(params, want, start, names):
    num = sum(float((params[n] - want[n]).norm()) ** 2 for n in names)
    den = sum(float((want[n] - start[n]).norm()) ** 2 for n in names)
    return (num / den) ** 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_1p2b"])
def test_train_step_matches_reference(arch, optimizer, dtype):
    cfg, jcfg = configs.get_smoke(arch), jget_smoke(arch)
    loss_tol, norm_tol, all_tol, leaf_tol, moment_tol, state_tol = \
        LIMITS[(dtype, optimizer)]
    state = _port_state(arch, optimizer)
    start = {n: p.detach().clone() for n, p in state.params.items()}
    jstate = _reference_start(arch, optimizer)
    jstep = jax.jit(functools.partial(
        jts.train_step, cfg=jcfg, optimizer=optimizer,
        compute_dtype=getattr(jnp, dtype), **STEP))
    src = pipeline.SyntheticLM(cfg.vocab, 64, 4, seed=0)
    for step in range(3):
        batch = src.batch_at(step)
        state, m = ts.train_step(state, batch, cfg=cfg, optimizer=optimizer,
                                 compute_dtype=getattr(torch, dtype), **STEP)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        assert set(m) == {"loss", "lr", "grad_norm", "aux"}
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=loss_tol)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=norm_tol)
        if step not in (0, 2):
            continue
        assert int(state.step) == int(jstate.step) == step + 1
        assert int(_moments(state.opt).step) == int(state.step)
        assert all(p.dtype == torch.float32 for p in state.params.values())
        want = _reference_flat(jstate.params, cfg)
        assert _update_distance(state.params, want, start, want) <= all_tol
        trees = [(getattr(_moments(state.opt), w),
                  getattr(_moments(jstate.opt), w)) for w in ("mu", "nu")]
        if optimizer == "muon":
            trees.append((state.opt.momentum, jstate.opt.momentum))
        for mine, ref in trees:
            ref = {n: None if v is None else torch.from_numpy(np.array(v))
                   for n, v in convert._reference_state(_np_tree(ref),
                                                        cfg).items()}
            assert _state_distance(mine, ref) <= state_tol
        if leaf_tol is None:
            continue
        for name in want:
            err = _update_distance(state.params, want, start, [name])
            assert err <= leaf_tol, (step, name, err)
        for which in ("mu", "nu"):
            mine = getattr(state.opt, which)
            ref = _reference_flat(getattr(jstate.opt, which), cfg)
            for name in ref:
                err = float((mine[name] - ref[name]).norm() / ref[name].norm())
                assert err <= moment_tol, (which, name, err)


@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
def test_make_train_step_matches_reference(optimizer):
    """One step of the mamba2 smoke config in float32 through each
    package's ``make_train_step`` (the reference's under ``jax.jit``):
    lr, loss, grad norm and the updated masters at the float32 limits of
    :data:`LIMITS`; the bound step is ``train_step`` with the config."""
    arch = "mamba2_370m"
    cfg, jcfg = configs.get_smoke(arch), jget_smoke(arch)
    loss_tol, norm_tol, all_tol = LIMITS[("float32", optimizer)][:3]
    kw = dict(optimizer=optimizer, **STEP)
    step = ts.make_train_step(cfg, compute_dtype=torch.float32, **kw)
    assert step.func is ts.train_step and step.keywords["cfg"] is cfg
    jstep = jax.jit(jts.make_train_step(jcfg, compute_dtype=jnp.float32,
                                        **kw))
    state = _port_state(arch, optimizer)
    start = {n: p.detach().clone() for n, p in state.params.items()}
    batch = pipeline.SyntheticLM(cfg.vocab, 64, 4, seed=0).batch_at(0)
    state, m = step(state, batch)
    jstate, jm = jstep(_reference_start(arch, optimizer),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-7)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=loss_tol)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=norm_tol)
    assert int(state.step) == int(jstate.step) == 1
    want = _reference_flat(jstate.params, cfg)
    assert _update_distance(state.params, want, start, want) <= all_tol


def test_train_loop_builds_its_step_through_make_train_step(monkeypatch):
    cfg = configs.get_smoke("phi3_mini")
    bound = []
    real = train_loop.make_train_step
    monkeypatch.setattr(train_loop, "make_train_step",
                        lambda c, **kw: bound.append((c, kw)) or real(c, **kw))
    train_loop.train(cfg, pipeline.SyntheticLM(cfg.vocab, 16, 2, seed=0), 2,
                     optimizer="muon", peak_lr=1e-3, warmup=1,
                     device="cpu", log_fn=lambda msg: None)
    assert bound == [(cfg, dict(optimizer="muon", peak_lr=1e-3, warmup=1,
                                total_steps=2))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_at_2048_tokens_matches_reference(dtype):
    """Four AdamW steps of the zamba2 smoke config at 1 × 2048 tokens,
    whose shared block takes the chunked attention, on the schedule of
    phase 14 (e) of ``chip_smoke.py`` (warm-up 2 of 4 steps, here at peak
    lr 1e-3): every step's loss and grad norm, and the params after the
    last, within the limits above [float32: 1.8e-7, 5.9e-6, 6.3e-5 over
    all leaves, 5.0e-4 per leaf; bf16: 1.9e-5, 6.8e-4, 0.036]."""
    arch = "zamba2_1p2b"
    cfg, jcfg = configs.get_smoke(arch), jget_smoke(arch)
    loss_tol, norm_tol, all_tol, leaf_tol, _, _ = LIMITS[(dtype, "adamw")]
    schedule = dict(peak_lr=1e-3, warmup=2, total_steps=4)
    state = _port_state(arch, "adamw")
    start = {n: p.detach().clone() for n, p in state.params.items()}
    jstate = _reference_start(arch, "adamw")
    jstep = jax.jit(functools.partial(
        jts.train_step, cfg=jcfg, compute_dtype=getattr(jnp, dtype),
        **schedule))
    src = pipeline.SyntheticLM(cfg.vocab, 2048, 1, seed=0)
    for step in range(4):
        batch = src.batch_at(step)
        state, m = ts.train_step(state, batch, cfg=cfg,
                                 compute_dtype=getattr(torch, dtype),
                                 **schedule)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=loss_tol)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=norm_tol)
    want = _reference_flat(jstate.params, cfg)
    assert _update_distance(state.params, want, start, want) <= all_tol
    for name in want if leaf_tol is not None else ():
        assert _update_distance(state.params, want, start, [name]) \
            <= leaf_tol, name


def test_train_step_accumulation_matches_one_batch_and_reference():
    """Two micro-batches of 2 average to the gradient of the batch of 4:
    the same update, within float32 AdamW's limits above; the reported
    loss is the last micro-batch's cross-entropy, as the reference
    reports it."""
    arch = "mamba2_370m"
    cfg, jcfg = configs.get_smoke(arch), jget_smoke(arch)
    batch = pipeline.SyntheticLM(cfg.vocab, 64, 4, seed=0).batch_at(0)
    kw = dict(cfg=cfg, compute_dtype=torch.float32, **STEP)
    one, m1 = ts.train_step(_port_state(arch, "adamw"), batch, **kw)
    two, m2 = ts.train_step(_port_state(arch, "adamw"), batch,
                            accum_steps=2, **kw)
    jstate, jm = jax.jit(functools.partial(
        jts.train_step, cfg=jcfg, accum_steps=2, compute_dtype=jnp.float32,
        **STEP))(_reference_start(arch, "adamw"),
                 {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = _reference_flat(jstate.params, cfg)
    start = {n: p.detach() for n, p in _port_state(arch, "adamw")
             .params.items()}
    _, _, all_tol, leaf_tol, _, _ = LIMITS[("float32", "adamw")]
    for other in (one.params, want):
        assert _update_distance(two.params, other, start, want) <= all_tol
        for name in want:
            assert _update_distance(two.params, other, start, [name]) \
                <= leaf_tol, name


def test_make_train_state_and_working_copy():
    """The masters stay float32 and the model's own (no graph on them);
    the optimizer state is keyed by the model's state-dict names."""
    cfg = configs.get_smoke("zamba2_1p2b")
    state = ts.make_train_state(cfg, optimizer="muon", seed=0, device="cpu")
    assert list(state.params) == list(state.model.state_dict())
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for p in state.params.values())
    assert set(state.opt.momentum) == set(state.params)
    src = pipeline.SyntheticLM(cfg.vocab, 32, 2, seed=1)
    state, m = ts.train_step(state, src.batch_at(0), cfg=cfg,
                             optimizer="muon", **STEP)
    assert all(p is q for p, q in zip(state.params.values(),
                                      state.model.parameters()))
    assert all(p.grad is None and not p.requires_grad
               for p in state.params.values())
    assert np.isfinite(float(m["loss"])) and int(state.step) == 1


# ----------------------------------------------------------------- data ---

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("rank,size", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_synthetic_batches_are_the_references_bytes(seed, rank, size):
    extra = {"frames": ((3, 5), "float32")}
    mine = pipeline.SyntheticLM(300, 16, 8, dp_rank=rank, dp_size=size,
                                seed=seed, extra_specs=extra)
    ref = jpipeline.SyntheticLM(300, 16, 8, dp_rank=rank, dp_size=size,
                                seed=seed, extra_specs=extra)
    for step in (0, 1, 5):
        got, want = mine.batch_at(step), ref.batch_at(step)
        assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
        for key in got:
            assert got[key].dtype == want[key].dtype
            assert got[key].tobytes() == want[key].tobytes(), (step, key)


def test_memmap_batches_are_the_references_bytes(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 2 ** 20, 5000).astype(
        np.uint32).tofile(path)
    for rank in (0, 1):
        mine = pipeline.MemmapLM(str(path), 1000, 32, 4, dp_rank=rank,
                                 dp_size=2, seed=3)
        ref = jpipeline.MemmapLM(str(path), 1000, 32, 4, dp_rank=rank,
                                 dp_size=2, seed=3)
        for step in (0, 4):
            got, want = mine.batch_at(step), ref.batch_at(step)
            for key in ("tokens", "labels"):
                assert got[key].tobytes() == want[key].tobytes()
        assert int(got["tokens"].max()) < 1000


def test_prefetcher_yields_batches_in_order_from_its_start():
    src = pipeline.SyntheticLM(100, 8, 2, seed=0)
    pre = pipeline.Prefetcher(src, start_step=3, depth=2)
    try:
        for want in (3, 4, 5, 6):
            step, batch = next(pre)
            assert step == want
            assert batch["tokens"].tobytes() == \
                src.batch_at(want)["tokens"].tobytes()
    finally:
        pre.close()
    assert not pre._thread.is_alive()


# ----------------------------------------------------------------- loop ---

def test_train_loop_improves_loss(tmp_path):
    cfg = configs.get_smoke("phi3_mini")
    src = pipeline.SyntheticLM(cfg.vocab, 32, 4, seed=0)
    losses = []
    seen = []
    train_loop.train(cfg, src, 30, ckpt_dir=str(tmp_path), save_every=10,
                     log_every=1, peak_lr=1e-3, device="cpu",
                     log_fn=losses.append,
                     on_step=lambda step, m, wall: seen.append(m["loss"]))
    assert len(seen) == 30 and sum("loss=" in msg for msg in losses) == 30
    assert seen[-1] < seen[0], (seen[0], seen[-1])
    assert sorted(d.name for d in tmp_path.iterdir()) == \
        ["step_10", "step_20", "step_30"]


def test_train_crash_and_resume_deterministic(tmp_path):
    """6 steps; a crash at step 3 (after the save at 2); the supervisor's
    restart resumes from it and lands on the uninterrupted run's final
    ``final_norm.g`` (rtol 1e-5, atol 1e-6, as the reference's test)."""
    cfg = configs.get_smoke("glm4_9b")
    src = pipeline.SyntheticLM(cfg.vocab, 32, 4, seed=0)
    ref_losses, losses = {}, {}
    state_ref = train_loop.train(
        cfg, src, 6, ckpt_dir=str(tmp_path / "ref"), save_every=2,
        log_every=1, device="cpu", log_fn=lambda m: None,
        on_step=lambda s, m, w: ref_losses.__setitem__(s, m["loss"]))
    sup = Supervisor(RestartPolicy(max_restarts=1, backoff_s=0),
                     sleep=lambda s: None)
    logs = []

    def run(attempt):
        return train_loop.train(
            cfg, src, 6, ckpt_dir=str(tmp_path / "crash"), save_every=2,
            log_every=1, device="cpu", log_fn=logs.append,
            fail_at_step=3 if attempt == 0 else None,
            on_step=lambda s, m, w: losses.__setitem__(s, m["loss"]))

    state = sup.run(run)
    assert sup.restarts == 1 and int(state.step) == 6
    assert "[train] restored checkpoint at step 2" in logs
    np.testing.assert_allclose(state.params["final_norm.g"].numpy(),
                               state_ref.params["final_norm.g"].numpy(),
                               rtol=1e-5, atol=1e-6)
    for step in range(2, 6):
        np.testing.assert_allclose(losses[step], ref_losses[step], rtol=1e-5)


def test_launch_train_smoke_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "mamba2-370m", "--smoke", "--steps", "4", "--seq",
            "32", "--batch", "2", "--device", "cpu", "--ckpt",
            str(tmp_path)]
    assert launch_train.main(argv) == 0
    assert "[train] done at step 4; restarts=0" in capsys.readouterr().out
    # a world of one: the (1, 1) mesh of make_host_mesh(model=2)
    assert launch_train.main(argv[:-2] + ["--model-parallel", "2"]) == 0
    out = capsys.readouterr().out
    assert "[train] done at step 4 on mesh {'data': 1, 'model': 1}" in out
