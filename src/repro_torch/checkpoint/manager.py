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

from . import store


def host_copy(tree: Any) -> Any:
    """``tree`` with every tensor copied to the host (a CPU tensor too:
    the caller goes on updating its own in place)."""
    return store.map_leaves(
        lambda _, x: x.detach().to("cpu", copy=True)
        if isinstance(x, torch.Tensor) else x, tree)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 keep_every: Optional[int] = None):
        self.directory = directory
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
        host_tree = host_copy(tree)
        copy_s = time.perf_counter() - t0
        nbytes = sum(leaf.numel() * leaf.element_size()
                     for _, leaf in store.leaf_paths(host_tree)
                     if isinstance(leaf, torch.Tensor))

        def work():
            try:
                t1 = time.perf_counter()
                store.save(self.directory, step, host_tree)
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

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from e

    # ---------------------------------------------------------- restore --
    def latest_step(self) -> Optional[int]:
        return store.latest_step(self.directory)

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no complete checkpoint under {self.directory}")
        return store.restore(self.directory, step, like)

    # ------------------------------------------------------- preemption --
    def install_sigterm_hook(self):
        """Make SIGTERM set ``preempted``; returns the handler it replaced,
        for the caller to put back when its run ends."""
        def handler(signum, frame):
            self.preempted.set()
        return signal.signal(signal.SIGTERM, handler)
