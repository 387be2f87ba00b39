"""Sharded training, serving and checkpoints on real process groups: gloo
on the CPU, four processes, a (2, 2) ``("data", "model")`` mesh from
``make_host_mesh(model=2)`` unless a test says otherwise.

* glm4-9b smoke: four AdamW steps in float32; the losses are finite,
  fall, and equal the unsharded port's within rtol 1e-4 (the unsharded
  port's match the reference's: ``tests/test_torch_train.py``) — the
  counterpart of the reference's ``test_sharded_train_step_8dev``.
* phi3-mini smoke (tied embeddings: the vocab-sharded lookup and the
  head share the table's gradient): two AdamW steps, the same check.
* olmoe-1b-7b smoke: two AdamW steps and one Muon step, against the
  unsharded port's at the same tolerance.
* A sharded prefill and greedy decode (yi-9b smoke, float32, the flash
  prefill on each rank's heads): the tokens equal the unsharded port's.
* The elastic checkpoint: saved on a (4,) mesh, restored on (2, 2) bit
  for bit; the reference's ``store.restore`` reads the port's manifest
  specs and the port restores a checkpoint the reference wrote.
* A sharded save gathers one leaf at a time: the full tensors alive at
  once never exceed the largest leaf, and only rank 0 keeps host arrays.
* ``launch.train --smoke --model-parallel 2`` under four ranks.
"""

import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import SyntheticLM

WORLD = 4
RTOL = 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, port, name, out_dir, args, init):
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(WORLD))
    if init:
        dist.init_process_group("gloo", rank=rank, world_size=WORLD)
    try:
        result = globals()[name](rank, *args)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, tmp_path, *args, init=True):
    """fn(rank, *args) on each of WORLD gloo ranks → the ranks' results."""
    out = tmp_path / "results"
    out.mkdir(exist_ok=True)
    mp.start_processes(_worker, args=(_free_port(), fn.__name__, str(out),
                                      args, init),
                       nprocs=WORLD, start_method="spawn")
    return [torch.load(out / f"{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _batches(cfg, n, seq=32, batch=8):
    src = SyntheticLM(cfg.vocab, seq, batch, seed=0)
    return [src.batch_at(i) for i in range(n)]


def _train(arch, optimizers, mesh=None):
    """Losses of consecutive steps (one optimizer each) from seed 0, in
    float32, sharded on ``mesh`` when given."""
    from repro_torch.sharding.context import activation_sharding, \
        shard_batch
    from repro_torch.train.train_step import make_train_state, train_step
    cfg = get_smoke(arch)
    losses = []
    for optimizer in dict.fromkeys(optimizers):
        state = make_train_state(cfg, optimizer=optimizer, seed=0,
                                 device="cpu", mesh=mesh)
        n = optimizers.count(optimizer)
        for b in _batches(cfg, n):
            batch = {k: torch.from_numpy(v) for k, v in b.items()}
            if mesh is None:
                state, m = train_step(state, batch, cfg=cfg,
                                      optimizer=optimizer, peak_lr=3e-3,
                                      warmup=1, total_steps=n,
                                      compute_dtype=torch.float32)
            else:
                with activation_sharding(mesh):
                    batch = {k: shard_batch(v) for k, v in batch.items()}
                    state, m = train_step(state, batch, cfg=cfg,
                                          optimizer=optimizer,
                                          peak_lr=3e-3, warmup=1,
                                          total_steps=n,
                                          compute_dtype=torch.float32)
            losses.append(float(m["loss"]))
    return losses


def sharded_train(rank, arch, optimizers):
    from repro_torch.launch.mesh import make_host_mesh
    return _train(arch, optimizers, make_host_mesh(model=2))


def test_sharded_adamw_steps_match_unsharded_glm4(tmp_path):
    optimizers = ["adamw"] * 4
    want = _train("glm4_9b", optimizers)
    results = run_world(sharded_train, tmp_path, "glm4_9b", optimizers)
    assert all(r == results[0] for r in results)    # one loss everywhere
    got = results[0]
    assert np.all(np.isfinite(got)) and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_sharded_adamw_steps_match_unsharded_tied_phi3(tmp_path):
    optimizers = ["adamw"] * 2
    want = _train("phi3_mini", optimizers)
    got = run_world(sharded_train, tmp_path, "phi3_mini", optimizers)[0]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_sharded_moe_adamw_and_muon_steps_olmoe(tmp_path):
    optimizers = ["adamw", "adamw", "muon"]
    want = _train("olmoe_1b_7b", optimizers)
    got = run_world(sharded_train, tmp_path, "olmoe_1b_7b", optimizers)[0]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _generate(cfg, model, prompt, steps, mesh=None):
    from repro_torch.launch import specs
    from repro_torch.models import api
    from repro_torch.serve.decode import ServeState, serve_step
    from repro_torch.sharding.context import activation_sharding, \
        shard_batch
    import contextlib
    ctx = activation_sharding(mesh) if mesh is not None \
        else contextlib.nullcontext()
    with ctx:
        b, s = prompt.shape
        caches = api.init_caches(model, cfg, b, s + steps + 1,
                                 dtype=torch.float32)
        tokens = torch.from_numpy(prompt)
        if mesh is not None:
            caches = specs.shard_caches(cfg, caches, mesh)
            tokens = shard_batch(tokens)
            # the sequence is split over "model": decode's masked read
            assert caches.kv.k.to_local().shape[2] == (s + steps + 1) // 2
        logits, caches = api.prefill(model, cfg, {"tokens": tokens}, caches)
        nxt = logits[:, -1].argmax(-1)[:, None]
        state = ServeState(caches=caches, last_tokens=nxt, rng=None)
        out = [nxt]
        for _ in range(steps):
            state, nxt = serve_step(state, model, cfg=cfg)
            out.append(nxt)
        out = torch.cat(out, dim=1)
        last = logits[:, -1]
        if mesh is not None:
            out, last = out.full_tensor(), last.full_tensor()
        return out.numpy(), last.numpy()


def sharded_decode(rank, arch, prompt, steps):
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    mesh = make_host_mesh(model=2)
    cfg = get_smoke(arch)
    model = api.init(cfg, seed=0, device="cpu")
    specs.shard_model(model, cfg, mesh)
    calls = []
    real = ops._flash.flash_attention_sharded
    ops._flash.flash_attention_sharded = \
        lambda *a, **k: calls.append(1) or real(*a, **k)
    tokens, logits = _generate(cfg, model, prompt, steps, mesh)
    return tokens, logits, len(calls)


def test_sharded_decode_tokens_equal_unsharded_yi(tmp_path):
    from repro_torch.models import api
    cfg = get_smoke("yi_9b")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (4, 256))
    model = api.init(cfg, seed=0, device="cpu")
    want, want_logits = _generate(cfg, model, prompt, 7)
    for tokens, logits, flash in run_world(sharded_decode, tmp_path,
                                           "yi_9b", prompt, 7):
        np.testing.assert_array_equal(tokens, want)
        np.testing.assert_allclose(logits, want_logits, rtol=1e-4,
                                   atol=1e-4)
        assert flash == cfg.n_layers        # one sharded flash a layer


def elastic(rank, directory, ref_directory):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.checkpoint import store
    w = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6) / 7
    mesh4 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    tree = {"w": distribute_tensor(w, mesh4, [Shard(0)]), "step": 3}
    store.save(directory, 3, tree)
    mesh22 = init_device_mesh("cpu", (2, 2),
                              mesh_dim_names=("data", "model"))
    out = {}
    for name, d in (("port", directory), ("reference", ref_directory)):
        back = store.restore(d, 3, {"w": w}, mesh=mesh22)["w"]
        out[name] = (back.full_tensor().numpy(), tuple(back.placements),
                     tuple(back.to_local().shape))
    return out


def test_elastic_checkpoint_across_meshes_and_packages(tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.checkpoint import store as ref_store
    from torch.distributed.tensor import Replicate, Shard
    w = (np.arange(8 * 6, dtype=np.float32).reshape(8, 6) / 7)
    ref_dir = str(tmp_path / "ref")
    ref_store.save(ref_dir, 3, {"w": jnp.asarray(w)},
                   specs={"w": P("data", None)}, mesh_shape={"data": 4})
    port_dir = str(tmp_path / "port")
    for r in run_world(elastic, tmp_path, port_dir, ref_dir):
        for name in ("port", "reference"):
            full, placements, local = r[name]
            assert full.tobytes() == w.tobytes(), name     # bit for bit
            assert placements == (Shard(0), Replicate()), name
            assert local == (4, 6), name
    import json
    manifest = json.load(open(os.path.join(port_dir, "step_3",
                                           "manifest.json")))
    entry = {e["name"]: e for e in manifest["leaves"]}["w"]
    assert entry["spec"] == ["data"] and manifest["mesh_shape"] == \
        {"data": 4}
    mesh = jax.make_mesh((1,), ("data",))
    back = ref_store.restore(port_dir, 3, {"w": jnp.asarray(w)}, mesh=mesh)
    assert np.asarray(back["w"]).tobytes() == w.tobytes()


def gather_peak(rank, directory):
    import weakref
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    from repro_torch.checkpoint import store
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=2)
    full = {f"w{i}": torch.arange(8 * (i + 1) * 6, dtype=torch.float32)
            .reshape(8 * (i + 1), 6) / 7 for i in range(4)}
    tree = {k: distribute_tensor(v, mesh, [Shard(0), Shard(1)])
            for k, v in full.items()}
    gathered, peaks = [], []
    real = DTensor.full_tensor

    def full_tensor(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        gathered.append(weakref.ref(out))
        peaks.append(sum(t.numel() * t.element_size()
                         for t in (r() for r in gathered) if t is not None))
        return out

    DTensor.full_tensor = full_tensor
    try:
        host, specs, _ = store.gather(tree)
        manager = CheckpointManager(directory, mesh=mesh)
        manager.save(1, {"params": tree, "step": 1}, blocking=True)
        manager.wait()
    finally:
        DTensor.full_tensor = real
    back = store.restore(directory, 1, {"params": full, "step": 0})
    return (max(peaks), len(peaks), specs,
            {k: None if v is None else v.numpy() for k, v in host.items()},
            {k: v.numpy() for k, v in back["params"].items()})


def test_sharded_save_gathers_one_leaf_at_a_time(tmp_path):
    full = {f"w{i}": np.arange(8 * (i + 1) * 6, dtype=np.float32)
            .reshape(8 * (i + 1), 6) / np.float32(7) for i in range(4)}
    largest = max(v.nbytes for v in full.values())
    results = run_world(gather_peak, tmp_path, str(tmp_path / "ckpt"))
    for rank, (peak, n, specs, host, back) in enumerate(results):
        assert n == 2 * len(full)             # gather, then the manager's
        assert peak == largest, (rank, peak, largest)
        assert specs == {k: ("data", "model") for k in full}
        for k, v in full.items():
            assert back[k].tobytes() == v.tobytes()
            if rank == 0:
                assert host[k].tobytes() == v.tobytes()
            else:
                assert host[k] is None        # rank 0 alone keeps arrays


def launch(rank, argv):
    from repro_torch.launch import train as launch_train
    return launch_train.main(argv)


def test_launch_train_model_parallel_on_four_ranks(tmp_path, capfd):
    argv = ["--arch", "glm4-9b", "--smoke", "--steps", "2", "--seq", "32",
            "--batch", "4", "--device", "cpu", "--model-parallel", "2",
            "--ckpt", str(tmp_path / "ckpt")]
    assert run_world(launch, tmp_path, argv, init=False) == [0] * WORLD
    assert "[train] done at step 2 on mesh {'data': 2, 'model': 2}" \
        in capfd.readouterr().out
    manifest = tmp_path / "ckpt" / "step_2" / "manifest.json"
    import json
    m = json.loads(manifest.read_text())
    assert m["mesh_shape"] == {"data": 2, "model": 2}
    assert any(e.get("spec") for e in m["leaves"])
