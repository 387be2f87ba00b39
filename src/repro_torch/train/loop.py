"""Checkpointed training loop: data prefetch → train step → asynchronous
save, as the reference's ``train/loop.py``.

It ties the fault-tolerance pieces together:
  * restore from the latest checkpoint on entry (so a
    :class:`~repro_torch.runtime.supervisor.Supervisor` restart resumes);
  * an asynchronous checkpoint every ``save_every`` steps, on the last
    step and on preemption, with retention; each save's bytes and seconds
    are logged when the run ends;
  * SIGTERM → save and a clean exit at the next step boundary (the
    previous handler is put back on return);
  * the straggler monitor on step wall times;
  * deterministic data: the batch index is the restored step
    (:mod:`repro_torch.data.pipeline`'s contract).

The step runs eagerly (:mod:`.train_step`): the reference jit-compiles
it, and a graph-captured step waits for the capture design of the
decode step (ROADMAP A6).
"""

from __future__ import annotations

import contextlib
import signal
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import Prefetcher
from repro_torch.models.layers import resolve_device
from repro_torch.models.transformer import ModelConfig
from repro_torch.runtime.supervisor import StragglerMonitor
from repro_torch.sharding.context import (active_mesh, activation_sharding,
                                          shard_batch)
from repro_torch.train.train_step import (TrainState, checkpoint_tree,
                                          load_checkpoint_tree,
                                          make_train_state, train_step)


def train(
    cfg: ModelConfig,
    source,                       # data source with .batch_at(step)
    total_steps: int,
    *,
    ckpt_dir: Optional[str] = None,
    save_every: int = 50,
    keep: int = 3,
    optimizer: str = "adamw",
    peak_lr: float = 3e-4,
    warmup: int = 20,
    log_every: int = 10,
    seed: int = 0,
    fail_at_step: Optional[int] = None,   # test hook: inject a crash
    log_fn: Callable[[str], None] = print,
    on_step: Optional[Callable[[int, Dict[str, float], float], None]] = None,
    device=None,
    mesh=None,
) -> TrainState:
    """Train ``cfg`` from random weights (``seed``) or the latest
    checkpoint under ``ckpt_dir`` up to ``total_steps`` on ``device`` (the
    card unless ``device="cpu"``); returns the final state. With a
    ``mesh`` the state is sharded over it, each rank takes its rows of
    every batch, steps run under ``activation_sharding(mesh)`` (unless
    the caller's context is active) and checkpoints carry the specs. ``on_step``,
    when given, receives each step's index, its metrics as floats and its
    wall seconds."""
    device = resolve_device(device)
    state = make_train_state(cfg, optimizer=optimizer, seed=seed,
                             device=device, mesh=mesh)
    mgr = CheckpointManager(ckpt_dir, keep=keep, mesh=mesh) \
        if ckpt_dir else None
    start_step = 0
    previous_handler = None
    if mgr is not None:
        latest = mgr.latest_step()
        if latest is not None:
            state = load_checkpoint_tree(
                state, mgr.restore(checkpoint_tree(state), step=latest))
            start_step = state.step
            log_fn(f"[train] restored checkpoint at step {start_step}")
        previous_handler = mgr.install_sigterm_hook()

    monitor = StragglerMonitor()
    prefetch = Prefetcher(source, start_step=start_step)
    # the hooks of an enclosing context stay as they are; a mesh alone
    # activates its own, a step at a time
    own = mesh is not None and active_mesh() is None
    try:
        for step in range(start_step, total_steps):
            bstep, np_batch = next(prefetch)
            if bstep != step:
                raise RuntimeError(f"prefetcher at batch {bstep}, "
                                   f"loop at step {step}")
            batch = {k: shard_batch(torch.from_numpy(v).to(device), mesh)
                     for k, v in np_batch.items()}
            t0 = time.perf_counter()
            with activation_sharding(mesh) if own else \
                    contextlib.nullcontext():
                state, metrics = train_step(
                    state, batch, cfg=cfg, optimizer=optimizer,
                    peak_lr=peak_lr, warmup=warmup, total_steps=total_steps)
            metrics = {k: float(v) for k, v in metrics.items()}
            wall = time.perf_counter() - t0
            slow = monitor.observe(step, wall)
            if on_step is not None:
                on_step(step, metrics, wall)
            if step % log_every == 0 or step == total_steps - 1:
                log_fn(f"[train] step={step} loss={metrics['loss']:.4f} "
                       f"lr={metrics['lr']:.2e} "
                       f"gnorm={metrics['grad_norm']:.3f} "
                       f"wall={wall*1e3:.0f}ms"
                       + (" [straggler]" if slow else ""))
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            want_save = mgr is not None and (
                (step + 1) % save_every == 0
                or step == total_steps - 1
                or mgr.preempted.is_set())
            if want_save:
                mgr.save(state.step, checkpoint_tree(state))
            if mgr is not None and mgr.preempted.is_set():
                log_fn(f"[train] preempted at step {step}; "
                       "checkpoint saved, exiting")
                break
        return state
    finally:
        # Drain a pending save on every exit, a crash included: a restart
        # must find the checkpoint it started.
        if mgr is not None:
            mgr.wait()
            for saved, nbytes, copy_s, write_s in mgr.saves:
                log_fn(f"[train] saved step {saved}: {nbytes / 1e9:.3f} GB, "
                       f"host copy {copy_s:.3f} s, write {write_s:.3f} s")
        prefetch.close()
        if previous_handler is not None:
            signal.signal(signal.SIGTERM, previous_handler)
