"""Data pipeline: synthetic + memmap token sources, host sharding, prefetch.

The port's own copy of the reference's ``data/pipeline.py`` (pure numpy):
``batch_at(step)`` returns the reference's bytes for every (seed, step,
dp_rank, dp_size).

  * **Determinism under restart/elasticity** — a batch is a pure function of
    (seed, step, dp_rank, dp_size); after a failure, the restored step
    counter alone reproduces the exact stream, and a *re-meshed* job (new
    dp_size) keeps per-sample determinism because sample ids are global.
  * **Host sharding** — each host materializes only its dp-rank slice.
  * **Prefetch** — a daemon thread keeps ``depth`` batches ahead so host
    data work overlaps device compute.

Two sources: ``SyntheticLM`` (zipfian tokens) and ``MemmapLM`` (np.memmap
over a packed uint32 token file) with the same determinism contract.
``SyntheticLM``'s ``extra_specs`` draws seed on ``hash(name)``, which
Python salts per process unless ``PYTHONHASHSEED`` is set: those arrays
repeat within a process only, as the reference's do.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


class SyntheticLM:
    """Zipf-distributed token batches with next-token labels."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 dp_rank: int = 0, dp_size: int = 1, seed: int = 0,
                 zipf_a: float = 1.2,
                 extra_specs: Optional[Dict[str, Tuple]] = None):
        assert global_batch % dp_size == 0
        self.vocab = vocab
        self.seq = seq_len
        self.local_batch = global_batch // dp_size
        self.global_batch = global_batch
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.seed = seed
        self.zipf_a = zipf_a
        self.extra_specs = extra_specs or {}

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        toks = np.empty((self.local_batch, self.seq + 1), dtype=np.int32)
        for i in range(self.local_batch):
            gid = step * self.global_batch \
                + self.dp_rank * self.local_batch + i
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, gid]))
            z = rng.zipf(self.zipf_a, size=self.seq + 1)
            toks[i] = (z - 1) % self.vocab
        out["tokens"] = toks[:, :-1]
        out["labels"] = toks[:, 1:]
        for name, (shape, dtype) in self.extra_specs.items():
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, hash(name) % 2**31]))
            out[name] = rng.standard_normal(
                (self.local_batch,) + tuple(shape)).astype(dtype)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapLM:
    """Packed-token memmap source with the same determinism contract."""

    def __init__(self, path: str, vocab: int, seq_len: int,
                 global_batch: int, dp_rank: int = 0, dp_size: int = 1,
                 seed: int = 0):
        self.tokens = np.memmap(path, dtype=np.uint32, mode="r")
        self.vocab = vocab
        self.seq = seq_len
        assert global_batch % dp_size == 0
        self.local_batch = global_batch // dp_size
        self.global_batch = global_batch
        self.dp_rank = dp_rank
        self.seed = seed
        self.n_windows = (len(self.tokens) - 1) // seq_len

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        toks = np.empty((self.local_batch, self.seq + 1), dtype=np.int32)
        for i in range(self.local_batch):
            gid = step * self.global_batch \
                + self.dp_rank * self.local_batch + i
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, gid]))
            w = int(rng.integers(0, self.n_windows))
            start = w * self.seq
            toks[i] = self.tokens[start: start + self.seq + 1] % self.vocab
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with bounded depth; `.close()` to stop."""

    _SENTINEL = object()

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        while True:
            try:
                return self.q.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
