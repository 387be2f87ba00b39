"""The port's checkpoints and supervisor, the counterparts of
tests/test_fault_tolerance.py, on the CPU: the store's round trip
(bfloat16 and ``None`` leaves), ignored partial saves, the integrity
check and retention; the manager's asynchronous save, restore and
preemption flag; the supervisor's retries and budget; the straggler
monitor and the heartbeat; and the on-disk layout shared with the
reference's store, read both ways. Restored leaves compare bit for bit.
"""

import os
import signal
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager, store
from repro_torch.optim import adamw, muon
from repro_torch.runtime.supervisor import (Heartbeat, RestartPolicy,
                                            StragglerMonitor, Supervisor)
from repro_torch.train import train_step as ts


def _leaves(tree):
    return list(store.leaf_paths(tree))


def tree_eq(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype, name
            assert torch.equal(x.view(torch.int16) if x.dtype ==
                               torch.bfloat16 else x,
                               y.view(torch.int16) if y.dtype ==
                               torch.bfloat16 else y), name
        else:
            assert x == y, name
    return True


def _tree():
    return {"a": torch.arange(12, dtype=torch.int32).reshape(3, 4),
            "nested": {"b": torch.full((5,), 2.5, dtype=torch.bfloat16),
                       "c": None},
            "opt": adamw.AdamWState(step=4, mu={"w": torch.ones(2, 3)},
                                    nu={"w": torch.zeros(2, 3)}),
            "step": 7}


# ------------------------------------------------------------- store -----

def test_store_roundtrip(tmp_path):
    tree = _tree()
    store.save(str(tmp_path), 7, tree)
    assert store.latest_step(str(tmp_path)) == 7
    out = store.restore(str(tmp_path), 7, tree)
    assert isinstance(out["opt"], adamw.AdamWState) and out["step"] == 7
    assert out["nested"]["c"] is None
    assert tree_eq(tree, out)
    names = [n for n, _ in _leaves(tree)]
    assert names == ["a", "nested/b", "nested/c", "opt/step", "opt/mu/w",
                     "opt/nu/w", "step"]


def test_store_bfloat16_bits_and_manifest(tmp_path):
    # 1, the largest finite, a denormal, -inf, a NaN payload
    bits = torch.from_numpy(np.array([0x3F80, 0x7F7F, 0x0001, 0xFF80, 0x7FC1],
                                     np.uint16).view(np.int16))
    tree = {"x": bits.view(torch.bfloat16)}
    d = store.save(str(tmp_path), 1, tree)
    arr = np.load(os.path.join(d, "x.npy"))
    assert arr.dtype == np.uint16
    import json
    entry = json.load(open(os.path.join(d, store.MANIFEST)))["leaves"][0]
    assert entry == {"name": "x", "file": "x.npy", "dtype": "bfloat16",
                     "shape": [5], "bytes": 10, "spec": None}
    out = store.restore(str(tmp_path), 1, tree)
    assert torch.equal(out["x"].view(torch.int16), bits)


def test_store_atomicity_tmp_dir_ignored(tmp_path):
    tree = {"a": torch.zeros(2)}
    store.save(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_9.tmp")      # a crashed save
    assert store.latest_step(str(tmp_path)) == 1
    os.makedirs(tmp_path / "step_5")          # no manifest: incomplete
    assert store.latest_step(str(tmp_path)) == 1


@pytest.mark.parametrize("corrupt", ["shape", "dtype"])
def test_store_integrity_check(tmp_path, corrupt):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    d = store.save(str(tmp_path), 2, tree)
    bad = np.zeros((4, 4), np.float32) if corrupt == "shape" \
        else np.zeros((2, 3), np.float64)
    np.save(os.path.join(d, "a.npy"), bad)
    with pytest.raises(ValueError, match="integrity"):
        store.restore(str(tmp_path), 2, tree)


def test_store_restore_checks_the_target_shape_and_leaves(tmp_path):
    store.save(str(tmp_path), 3, {"a": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        store.restore(str(tmp_path), 3, {"a": torch.zeros(3, 2)})
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        store.restore(str(tmp_path), 3, {"b": torch.zeros(2, 3)})


def test_store_retention(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        store.save(str(tmp_path), s, tree)
    store.retain(str(tmp_path), keep=2)
    left = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert left == ["step_3", "step_4"]


def test_port_reads_what_the_reference_wrote(tmp_path):
    ref = {"a": jnp.arange(12).reshape(3, 4),
           "nested": {"b": jnp.ones((5,), jnp.bfloat16) * 2, "c": None},
           "step": jnp.asarray(3, jnp.int32)}
    jstore.save(str(tmp_path), 7, ref)
    assert store.latest_step(str(tmp_path)) == 7
    like = {"a": torch.zeros(3, 4, dtype=torch.int32),
            "nested": {"b": torch.zeros(5, dtype=torch.bfloat16), "c": None},
            "step": 0}
    out = store.restore(str(tmp_path), 7, like)
    assert torch.equal(out["a"], torch.arange(12, dtype=torch.int32)
                       .reshape(3, 4))
    assert out["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["nested"]["b"].float(), torch.full((5,), 2.0))
    assert out["nested"]["c"] is None and out["step"] == 3


def test_reference_reads_what_the_port_wrote(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.full((4,), -1.5, dtype=torch.bfloat16)}
    store.save(str(tmp_path), 5, tree)
    assert jstore.latest_step(str(tmp_path)) == 5
    out = jstore.restore(str(tmp_path), 5,
                         {"a": jnp.zeros((2, 3)),
                          "b": jnp.zeros((4,), jnp.bfloat16)})
    np.testing.assert_array_equal(np.asarray(out["a"]), tree["a"].numpy())
    assert out["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(out["b"], np.float32),
                                  np.full(4, -1.5, np.float32))


def test_train_state_round_trips_bit_for_bit(tmp_path):
    """A Muon state (``None`` momenta included) through the manager, into
    a fresh state of the same config: every leaf equal bit for bit."""
    cfg = configs.get_smoke("mamba2_370m")
    state = ts.make_train_state(cfg, optimizer="muon", seed=1, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for t in state.opt.adamw.mu.values():
        t.copy_(torch.randn(t.shape, generator=gen))
    state.step.fill_(3)
    state.opt.step.fill_(2)
    state.opt.adamw.step.fill_(2)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(0, ts.checkpoint_tree(state))
    mgr.wait()
    fresh = ts.make_train_state(cfg, optimizer="muon", seed=2, device="cpu")
    kept = ts.state_tensors(fresh)
    out = ts.load_checkpoint_tree(fresh, mgr.restore(
        ts.checkpoint_tree(fresh)))
    assert int(out.step) == 3 and isinstance(out.opt, muon.MuonState)
    assert int(out.opt.step) == int(out.opt.adamw.step) == 2
    assert tree_eq(ts.checkpoint_tree(state), ts.checkpoint_tree(out))
    assert out.params is fresh.params       # restored in place
    assert all(a is b for a, b in zip(ts.state_tensors(out), kept))
    assert mgr.saves[0][0] == 0 and mgr.saves[0][1] > 0


# ------------------------------------------------------------ manager ----

def test_manager_async_save_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    w = torch.ones(4, 4)
    for s in (1, 2, 3):
        w.fill_(float(s))
        mgr.save(s, {"w": w})
        w.fill_(-1.0)           # the saved copy was taken before this
    mgr.wait()
    assert mgr.latest_step() == 3
    out = mgr.restore({"w": torch.zeros(4, 4)})
    assert torch.equal(out["w"], torch.full((4, 4), 3.0))
    assert torch.equal(mgr.restore({"w": w}, step=2)["w"],
                       torch.full((4, 4), 2.0))
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_2", "step_3"]  # retention
    assert [s for s, *_ in mgr.saves] == [1, 2, 3]


def test_manager_keep_every_and_failed_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, keep_every=2)
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, {"w": torch.zeros(1)}, blocking=True)
    assert store.steps(str(tmp_path)) == [2, 4, 5]
    mgr.save(6, {"w": object()})
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})


def test_manager_preemption_flag_and_sigterm_hook(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert not mgr.preempted.is_set()
    previous = mgr.install_sigterm_hook()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not mgr.preempted.is_set() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert mgr.preempted.is_set()
    finally:
        signal.signal(signal.SIGTERM, previous)


# ---------------------------------------------------------- supervisor ---

def test_supervisor_retries_until_success():
    calls = []

    def flaky(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise RuntimeError("boom")
        return "done"

    slept = []
    sup = Supervisor(RestartPolicy(max_restarts=5, backoff_s=0.5,
                                   backoff_mult=3.0, max_backoff_s=1.0),
                     sleep=slept.append)
    assert sup.run(flaky) == "done"
    assert calls == [0, 1, 2]
    assert sup.restarts == 2 and len(sup.failures) == 2
    assert slept == [0.5, 1.0]


def test_supervisor_budget_exhaustion():
    sup = Supervisor(RestartPolicy(max_restarts=2, backoff_s=0),
                     sleep=lambda s: None)
    with pytest.raises(RuntimeError, match="restart budget"):
        sup.run(lambda attempt: (_ for _ in ()).throw(RuntimeError("x")))
    assert sup.restarts == 3


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(alpha=0.5, threshold=2.0, warmup_steps=2)
    for i in range(5):
        assert not mon.observe(i, 0.1)
    assert mon.observe(5, 0.5)       # 5× the EMA → flagged
    assert mon.flagged == [5]
    assert not mon.observe(6, 0.1)   # EMA not poisoned by the straggler


def test_heartbeat_detects_death():
    hb = Heartbeat(interval_s=0.05, miss_limit=2)
    assert not hb.is_alive()
    hb.start()
    time.sleep(0.12)
    assert hb.is_alive()
    hb.stop()
    assert not hb._thread.is_alive()
    last = hb.last_beat
    assert not hb.is_alive(now=last + 1.0)
