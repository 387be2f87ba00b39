"""Checkpoint manager: asynchronous saves, retention, the preemption hook.

The reference's ``checkpoint/manager.py`` over :mod:`.store`:

  * **Asynchronous save** — ``save`` copies every tensor to the host on
    the caller's thread, before the next step changes it in place (a
    device-to-host copy is cheap beside a step), and a background thread
    writes the copy; ``wait()`` drains it before an exit or a restore.
    Each finished save is logged in ``saves`` as (step, bytes, seconds of
    the host copy, seconds of the write).
  * **Retention** — keep the newest ``keep`` checkpoints (and, with
    ``keep_every``, every multiple of it forever).
  * **Sharded state** — DTensor leaves are gathered on every rank, one
    leaf at a time to the host, and rank 0 writes them with their specs
    (:func:`.store.gather`); with a ``mesh`` ``wait()`` ends at a
    barrier, so no rank reads a checkpoint before it is complete.
  * **Preemption** — ``install_sigterm_hook`` makes SIGTERM set
    ``preempted``; the train loop then saves and exits at the next step
    boundary, and puts the previous handler back when it returns.
"""

from __future__ import annotations

import os
import shutil
import signal
import threading
import time
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from . import store


def _distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 keep_every: Optional[int] = None, mesh=None):
        self.directory = directory
        self.mesh = mesh
        self.keep = keep
        self.keep_every = keep_every
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.preempted = threading.Event()
        self.saves: List[Tuple[int, int, float, float]] = []
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save --
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()
        t0 = time.perf_counter()
        host_tree, specs, mesh_shape = store.gather(tree, copy=True)
        if _distributed() and dist.get_rank() != 0:
            return          # rank 0 writes; wait() meets it at a barrier
        copy_s = time.perf_counter() - t0
        nbytes = sum(leaf.numel() * leaf.element_size()
                     for _, leaf in store.leaf_paths(host_tree)
                     if isinstance(leaf, torch.Tensor))

        def work():
            try:
                t1 = time.perf_counter()
                store.save(self.directory, step, host_tree, specs=specs,
                           mesh_shape=mesh_shape)
                self.saves.append((step, nbytes, copy_s,
                                   time.perf_counter() - t1))
                self._retain()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if blocking:
            work()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def _retain(self) -> None:
        done = store.steps(self.directory)
        kept = ({s for s in done if s % self.keep_every == 0}
                if self.keep_every else set())
        candidates = [s for s in done if s not in kept]
        for s in candidates[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()
        if self.mesh is not None and _distributed():
            dist.barrier()   # the other ranks read what rank 0 wrote

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from e

    # ---------------------------------------------------------- restore --
    def latest_step(self) -> Optional[int]:
        return store.latest_step(self.directory)

    def restore(self, like: Any, step: Optional[int] = None,
                mesh=None) -> Any:
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no complete checkpoint under {self.directory}")
        return store.restore(self.directory, step, like, mesh=mesh)

    # ------------------------------------------------------- preemption --
    def install_sigterm_hook(self):
        """Make SIGTERM set ``preempted``; returns the handler it replaced,
        for the caller to put back when its run ends."""
        def handler(signum, frame):
            self.preempted.set()
        return signal.signal(signal.SIGTERM, handler)
