"""The port's graph-safe train step against the JAX package's, on the CPU.

``train.loop.train`` captures the train step in a CUDA graph on the card
(``train_step.compile_train_step``) and replays it for every step after
the first. A replay re-runs the captured kernels on the same buffers, so
the step must (1) read nothing on the host and build no tensor from host
data, and (2) advance all its state in place. These tests hold both on
the CPU, with ``HOST_OPS`` and ``NoHostData`` of
tests/test_torch_graph_decode.py:

* (1) one train step under the mode, for AdamW and Muon at
  ``accum_steps`` 1 and 2, on the mamba2 and zamba2 smoke configs (the
  archs ``test_train_step_matches_reference`` holds against the
  reference), and the sharded decode step on a gloo world of one;
* (2) every master, moment, momentum and counter is the same tensor, at
  the same address, after 3 steps; a restored checkpoint, an int step
  of the older format included, is copied into those tensors;
* the device counters give the reference's numbers: lr at steps 0–3
  for every schedule and AdamW's bias corrections, bit for bit;
* the capture refuses what it cannot take: a CPU state (``ValueError``),
  a sharded one too, and ``train(capture=True)`` on the CPU, with or
  without a mesh.

On a mesh the card captures the sharded step as it is (DTensor's
dispatch runs on the host while the graph records, after a warm-up step
in the same ``activation_sharding`` context):

* (1) the sharded step under the mode on a fake (2, 2) world of four in
  this process (its collectives are real DTensor dispatches, the fake
  group's do nothing), for AdamW and Muon at ``accum_steps`` 1 and 2,
  after a warm-up step, drawing no random number;
* (2) on a gloo (2, 2) world of four processes, three steps keep every
  state DTensor's local tensor at its address, ``context.batch_rows``
  gives each rank's ``shard_batch`` rows, and the loop's static batch
  (``train_step._static`` of a ``shard_batch`` DTensor, each later batch
  copied in by ``train_step.copy_batch``) trains to the losses of
  freshly sharded batches.

The capture itself needs the card: tests/test_torch_gpu.py holds the
captured step against the eager one there, sharded on an NCCL world of
one too.
"""

import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor

from repro.optim import schedule as jschedule
from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim import adamw, schedule
from repro_torch.train import loop as train_loop
from repro_torch.train import train_step as ts
from test_torch_distribution import WORLD, run_world
from test_torch_graph_decode import NoHostData

ARCHS = ("mamba2_370m", "zamba2_1p2b")
STEP = dict(peak_lr=1e-3, warmup=0, total_steps=10)


def _state(arch, optimizer):
    return ts.make_train_state(configs.get_smoke(arch), optimizer=optimizer,
                               seed=0, device="cpu")


def _batch(cfg, step):
    return {k: torch.from_numpy(v) for k, v in
            SyntheticLM(cfg.vocab, 64, 4, seed=0).batch_at(step).items()}


@pytest.mark.parametrize("accum_steps", [1, 2])
@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_reads_nothing_on_the_host(arch, optimizer, accum_steps):
    """The whole step (forward, backward, accumulation, clip, schedule,
    optimizer) under the mode; the batch is a tensor on the state's
    device, as a replay's static buffers are."""
    cfg = configs.get_smoke(arch)
    state, batch = _state(arch, optimizer), _batch(cfg, 0)
    with NoHostData() as mode:
        out, m = ts.train_step(state, batch, cfg=cfg,
                               optimizer=optimizer, accum_steps=accum_steps,
                               **STEP)
    assert out is state and mode.calls > 0
    assert set(m) == {"loss", "lr", "grad_norm", "aux"}
    assert all(v.shape == () and v.dtype == torch.float32
               for v in m.values())
    assert np.isfinite(float(m["loss"])) and float(m["lr"]) > 0
    assert int(state.step) == 1


@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
def test_three_steps_write_the_same_tensors(optimizer):
    """Every tensor of the state, by identity and address, after three
    steps; the counters advanced on the device and the masters moved."""
    arch = "mamba2_370m"
    cfg = configs.get_smoke(arch)
    state = _state(arch, optimizer)
    before = ts.state_tensors(state)
    ptrs = [t.data_ptr() for t in before]
    start = {n: p.clone() for n, p in state.params.items()}
    counters = [t for t in before if t.dim() == 0]
    assert len(counters) == (3 if optimizer == "muon" else 2)
    assert all(t.dtype == torch.int32 for t in counters)
    step = ts.make_train_step(cfg, optimizer=optimizer, **STEP)
    for i in range(3):
        new, _ = step(state, _batch(cfg, i))
        assert new is state
    after = ts.state_tensors(state)
    assert len(after) == len(before)
    assert all(a is b for a, b in zip(after, before))
    assert [t.data_ptr() for t in after] == ptrs
    assert [int(t) for t in counters] == [3] * len(counters)
    assert all(not torch.equal(p, start[n])
               for n, p in state.params.items() if p.dim() >= 2)


@pytest.mark.parametrize("name", sorted(schedule.SCHEDULES))
def test_lr_from_the_device_counter_is_the_reference_lr(name):
    """Steps 0–3 (warm-up 2 of 10: both branches) from an int32 counter
    advanced in place, bit for bit the reference's schedule."""
    counter = adamw.counter("cpu")
    for step in range(4):
        got = schedule.SCHEDULES[name](counter, 3e-4, 2, 10)
        want = jschedule.SCHEDULES[name](jnp.asarray(step, jnp.int32), 3e-4,
                                         2, 10)
        assert got.dtype == torch.float32 and got.shape == ()
        assert np.float32(got.item()) == np.asarray(want), (step, name)
        counter.add_(1)


def test_bias_corrections_from_the_device_counter_are_the_references():
    """AdamW's 1 − b^step at steps 0–3, as the reference's ``update``
    computes them (``b ** step.astype(float32)``), bit for bit."""
    for step in range(4):
        bc1, bc2 = adamw.bias_corrections(
            torch.tensor(step, dtype=torch.int32), 0.9, 0.95)
        s = jnp.asarray(step, jnp.int32).astype(jnp.float32)
        for got, b in ((bc1, 0.9), (bc2, 0.95)):
            assert got.dtype == torch.float32 and got.shape == ()
            assert np.float32(got.item()) == np.asarray(1 - b ** s), step


def test_checkpoint_with_an_int_step_restores_into_the_counters(tmp_path):
    """The format written while the counters were host ints: ``step``
    and the optimizer's ``step`` as Python ints. It restores into a
    fresh state's own counters (int32, on its device), values and all,
    and the masters and moments in place."""
    cfg = configs.get_smoke("mamba2_370m")
    old = _state("mamba2_370m", "adamw")
    for t in old.opt.mu.values():
        t.fill_(0.25)
    tree = {"params": old.params,
            "opt": adamw.AdamWState(step=5, mu=old.opt.mu, nu=old.opt.nu),
            "step": 5}
    store.save(str(tmp_path), 5, tree)
    fresh = ts.make_train_state(cfg, seed=1, device="cpu")
    kept = ts.state_tensors(fresh)
    out = ts.load_checkpoint_tree(fresh, store.restore(
        str(tmp_path), 5, ts.checkpoint_tree(fresh)))
    assert out is fresh
    assert all(a is b for a, b in zip(ts.state_tensors(out), kept))
    for counter in (out.step, out.opt.step):
        assert counter.dtype == torch.int32 and counter.shape == ()
        assert int(counter) == 5
    assert all(torch.equal(out.params[n], p) for n, p in old.params.items())
    assert all(bool((t == 0.25).all()) for t in out.opt.mu.values())


def test_a_mesh_restore_fills_the_plain_counters(tmp_path):
    """On a mesh the restore returns every leaf as a DTensor, the counters
    too (replicated); they are copied into the state's plain counters and
    its DTensor masters and moments in place (a fake world of one)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_host_mesh

    cfg = configs.get_smoke("mamba2_370m")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(model=1)
        old = ts.make_train_state(cfg, seed=0, device="cpu", mesh=mesh)
        old.step.fill_(4)
        old.opt.step.fill_(4)
        store.save(str(tmp_path), 4, ts.checkpoint_tree(old))
        fresh = ts.make_train_state(cfg, seed=1, device="cpu", mesh=mesh)
        kept = ts.state_tensors(fresh)
        back = store.restore(str(tmp_path), 4, ts.checkpoint_tree(fresh),
                             mesh=mesh)
        assert isinstance(back["step"], DTensor)
        out = ts.load_checkpoint_tree(fresh, back)
        assert all(a is b for a, b in zip(ts.state_tensors(out), kept))
        assert not isinstance(out.step, DTensor)
        assert int(out.step) == int(out.opt.step) == 4
        assert all(torch.equal(p.full_tensor(), old.params[n].full_tensor())
                   for n, p in out.params.items())
    finally:
        dist.destroy_process_group()


def test_compile_train_step_refuses_a_cpu_state():
    cfg = configs.get_smoke("mamba2_370m")
    state = _state("mamba2_370m", "adamw")
    with pytest.raises(ValueError, match="CUDA device"):
        ts.compile_train_step(ts.make_train_step(cfg), state, _batch(cfg, 0))
    assert int(state.step) == 0          # nothing ran


def test_compile_train_step_refuses_a_sharded_state():
    """A DTensor state on the CPU (a fake world of one) raises the CPU
    state's ``ValueError`` before anything runs."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        w = distribute_tensor(torch.ones(4, 4), mesh, [Replicate()])
        state = ts.TrainState(params={"w": w}, opt=None,
                              step=adamw.counter("cpu"), model=None)
        calls = []
        with pytest.raises(ValueError, match="CUDA device"):
            ts.compile_train_step(lambda s, b: calls.append(1), state, {})
        assert not calls
    finally:
        dist.destroy_process_group()


def test_train_with_capture_raises_on_the_cpu():
    cfg = configs.get_smoke("mamba2_370m")
    source = SyntheticLM(cfg.vocab, 32, 2, seed=0)
    with pytest.raises(ValueError, match="CUDA device"):
        train_loop.train(cfg, source, 2, device="cpu", capture=True,
                         log_fn=lambda msg: None)
    state = train_loop.train(cfg, source, 2, device="cpu",
                             log_fn=lambda msg: None)   # eager by default
    assert int(state.step) == 2


def test_train_on_a_mesh_with_capture_raises_on_the_cpu():
    """On a mesh (a fake world of one) ``capture=True`` on the CPU raises
    as it does unsharded; the CPU's default runs the sharded step
    eagerly."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_host_mesh

    cfg = configs.get_smoke("mamba2_370m")
    source = SyntheticLM(cfg.vocab, 32, 2, seed=0)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(model=1)
        with pytest.raises(ValueError, match="CUDA device"):
            train_loop.train(cfg, source, 2, device="cpu", mesh=mesh,
                             capture=True, log_fn=lambda msg: None)
        state = train_loop.train(cfg, source, 2, device="cpu", mesh=mesh,
                                 log_fn=lambda msg: None)
        assert int(state.step) == 2
        assert all(isinstance(p, DTensor) for p in state.params.values())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("accum_steps", [1, 2])
@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
def test_sharded_train_step_reads_nothing_on_the_host(optimizer,
                                                      accum_steps):
    """The mamba2 smoke step on the (2, 2) mesh of a fake world of four:
    a warm-up step, then, in the same context, a step under the mode, as
    ``compile_train_step`` warms up and captures. The model axis shards
    the vocab (``loss_parallel``) and every projection; the fake group's
    collectives return made-up data, so only the host reads, the state's
    storage and the metrics' types are checked. The step draws no random
    number."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.context import activation_sharding, \
        shard_batch

    cfg = configs.get_smoke("mamba2_370m")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    try:
        mesh = make_host_mesh(model=2)
        state = ts.make_train_state(cfg, optimizer=optimizer, seed=0,
                                    device="cpu", mesh=mesh)
        before = ts._fingerprint(state)
        step = ts.make_train_step(cfg, optimizer=optimizer,
                                  accum_steps=accum_steps, **STEP)
        rng = torch.get_rng_state()
        with activation_sharding(mesh):
            batch = {k: shard_batch(v) for k, v in _batch(cfg, 0).items()}
            step(state, batch)
            with NoHostData() as mode:
                out, m = step(state, batch)
        assert mode.calls > 0
        assert ts._fingerprint(out) == before
        assert torch.equal(torch.get_rng_state(), rng)
        assert set(m) == {"loss", "lr", "grad_norm", "aux"}
        assert all(type(v) is torch.Tensor and v.shape == ()
                   and v.dtype == torch.float32 for v in m.values())
        assert int(state.step) == 2
    finally:
        dist.destroy_process_group()


def sharded_steps(rank, optimizers):
    """Three mamba2 smoke steps from seed 0 on the (2, 2) mesh, per
    optimizer: on freshly sharded batches, and (the first optimizer) on
    the loop's static batch → {"rows": whether ``batch_rows`` gave
    ``shard_batch``'s local rows for every entry, (optimizer, feed):
    (losses, whether the state kept its tensors and local storage after
    each step)}."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.context import activation_sharding, \
        batch_rows, shard_batch

    mesh = make_host_mesh(model=2)
    cfg = configs.get_smoke("mamba2_370m")
    src = SyntheticLM(cfg.vocab, 32, 8, seed=0)
    batches = [{k: torch.from_numpy(v) for k, v in src.batch_at(i).items()}
               for i in range(3)]
    out = {"rows": all(torch.equal(batch_rows(v, mesh),
                                   shard_batch(v, mesh).to_local())
                       for b in batches for v in b.values())}
    runs = [(o, "fresh") for o in optimizers] + [(optimizers[0], "static")]
    for optimizer, feed in runs:
        step = ts.make_train_step(cfg, optimizer=optimizer, **STEP)
        state = ts.make_train_state(cfg, optimizer=optimizer, seed=0,
                                    device="cpu", mesh=mesh)
        before = ts._fingerprint(state)
        losses, same, static = [], [], None
        with activation_sharding(mesh):
            for b in batches:
                if feed == "fresh":
                    batch = {k: shard_batch(v) for k, v in b.items()}
                elif static is None:
                    batch = static = {k: ts._static(shard_batch(v), "cpu")
                                      for k, v in b.items()}
                else:
                    ts.copy_batch(static, b)
                new, m = step(state, batch)
                losses.append(float(m["loss"]))
                same.append(ts._fingerprint(new) == before)
        out[(optimizer, feed)] = (losses, same)
    return out


@pytest.fixture(scope="module")
def gloo_steps(tmp_path_factory):
    """:func:`sharded_steps` on each rank of a gloo world of four."""
    return run_world(sharded_steps, tmp_path_factory.mktemp("gloo"),
                     ("adamw", "muon"))


@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
def test_sharded_steps_keep_the_local_storage(gloo_steps, optimizer):
    """Every rank: after each of three steps every state tensor is the
    same object over the same local storage (a replay writes there), and
    the ranks agree on the losses."""
    runs = [r[(optimizer, "fresh")] for r in gloo_steps]
    assert all(same == [True] * 3 for _, same in runs)
    losses = [loss for loss, _ in runs]
    assert all(x == losses[0] for x in losses)
    assert np.all(np.isfinite(losses[0]))


def test_static_batch_rows_are_shard_batch_rows(gloo_steps):
    """Every rank's ``batch_rows`` of every batch entry is the local
    tensor of ``shard_batch``'s DTensor."""
    assert [r["rows"] for r in gloo_steps] == [True] * WORLD


def test_steps_on_the_static_batch_match_freshly_sharded_batches(
        gloo_steps):
    """Three steps fed as the captured loop feeds them (one static
    DTensor batch, the next rows copied into its local tensor) give the
    losses of freshly sharded batches, bit for bit, on every rank, with
    the state's storage kept."""
    for r in gloo_steps:
        static, same = r[("adamw", "static")]
        assert same == [True] * 3
        assert static == r[("adamw", "fresh")][0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sharded_decode_worker(rank, port, prompt, steps, out):
    """Yi-9B smoke (float32) on the (1, 1) mesh of a gloo world of one:
    a prefill, then ``steps`` serve steps as a replay drives them, each
    under the mode → (tokens, whether the caches stayed the same
    tensors, the mode's op count)."""
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.serve import decode
    from repro_torch.sharding.context import activation_sharding, \
        shard_batch

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=1)
    try:
        mesh = make_host_mesh(model=1)
        cfg = configs.get_smoke("yi_9b")
        model = api.init(cfg, seed=0, device="cpu")
        specs.shard_model(model, cfg, mesh)
        b, s = prompt.shape
        with activation_sharding(mesh):
            caches = specs.shard_caches(cfg, api.init_caches(
                model, cfg, b, s + steps + 1, dtype=torch.float32), mesh)
            logits, caches = api.prefill(
                model, cfg, {"tokens": shard_batch(torch.from_numpy(prompt))},
                caches)
            first = logits[:, -1].argmax(-1)[:, None]
            state = decode.ServeState(caches, first.clone(), None)
            leaves = [id(t) for t in decode._leaves(caches)]
            step = decode.make_serve_step(cfg)
            tokens, same, calls = [first.full_tensor()], True, 0
            for _ in range(steps):
                with NoHostData() as mode:
                    new, nxt = step(state, model)
                calls += mode.calls
                same &= [id(t) for t in decode._leaves(new.caches)] == leaves
                state.last_tokens.copy_(nxt)
                tokens.append(nxt.full_tensor())
        torch.save((torch.cat(tokens, 1), same, calls), out)
    finally:
        dist.destroy_process_group()


def test_sharded_decode_step_reads_nothing_on_the_host(tmp_path):
    """The sharded serve step, which ``generate`` now captures, under the
    mode on the (1, 1) mesh of a gloo world of one (in a process of its
    own, as tests/test_torch_distribution.py runs its worlds): no host
    read, its caches written in place, and its tokens the unsharded
    step's."""
    from repro_torch.models import api
    from repro_torch.serve import decode

    cfg = configs.get_smoke("yi_9b")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))
    out = tmp_path / "sharded.pt"
    mp.start_processes(_sharded_decode_worker,
                       args=(_free_port(), prompt, 4, str(out)), nprocs=1,
                       start_method="spawn")
    tokens, same, calls = torch.load(out, weights_only=False)
    assert same and calls > 0
    model = api.init(cfg, seed=0, device="cpu")
    caches = api.init_caches(model, cfg, 2, 17, dtype=torch.float32)
    logits, caches = api.prefill(model, cfg,
                                 {"tokens": torch.from_numpy(prompt)}, caches)
    state = decode.ServeState(caches, logits[:, -1].argmax(-1)[:, None],
                              None)
    want = [state.last_tokens.clone()]
    for _ in range(4):
        _, nxt = decode.serve_step(state, model, cfg=cfg)
        state.last_tokens.copy_(nxt)
        want.append(nxt.clone())
    assert torch.equal(tokens, torch.cat(want, 1))

