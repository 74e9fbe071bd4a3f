"""Deterministic, shardable, resumable data pipeline (numpy and threads).

Counterpart of :mod:`repro.data.pipeline`, copied so that the port imports
nothing of the reference: the same seeds give the same batches.

Production-shaped guarantees without external deps:
* **Determinism** — batch ``i`` of shard ``s`` depends only on (seed, i, s)
  via numpy ``SeedSequence``; restarts reproduce the identical stream.
* **Sharding** — each data-parallel host pulls only its shard (``shard_id``,
  ``n_shards``); no coordination needed.
* **Resumability** — state is a single step counter; ``state()`` /
  ``restore()`` round-trips through checkpoints (fault tolerance).
* **Backpressure-free prefetch** — a bounded background thread keeps
  ``prefetch`` batches ready (the streaming paper's jumbo-tuple + bounded
  queue pattern applied to the input pipeline).

Two sources: synthetic LM tokens (zipfian, so losses are non-degenerate) and
a memory-mapped binary corpus (``BinTokenSource``).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


def _check_shards(batch: int, n_shards: int) -> None:
    if n_shards < 1 or batch % n_shards:
        raise ValueError(f"batch {batch} does not split into {n_shards} shards")


@dataclasses.dataclass
class PipelineState:
    step: int
    seed: int
    shard_id: int
    n_shards: int

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d):
        return PipelineState(**d)


class SyntheticLM:
    """Zipfian synthetic token stream -> {'inputs', 'labels'} batches."""

    def __init__(self, batch: int, seq: int, vocab: int, seed: int = 0,
                 shard_id: int = 0, n_shards: int = 1, alpha: float = 1.1):
        _check_shards(batch, n_shards)
        self.batch = batch // n_shards
        self.seq = seq
        self.vocab = vocab
        self.st = PipelineState(0, seed, shard_id, n_shards)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        probs = ranks ** -alpha
        self._cdf = np.cumsum(probs / probs.sum())

    def state(self) -> Dict:
        return self.st.to_dict()

    def restore(self, d: Dict) -> None:
        self.st = PipelineState.from_dict(d)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence(
                [self.st.seed, self.st.shard_id, step]))

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = self._rng(self.st.step)
        u = rng.random((self.batch, self.seq + 1))
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        toks = np.clip(toks, 0, self.vocab - 1)
        self.st.step += 1
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


class BinTokenSource:
    """Memory-mapped corpus of int32 tokens; deterministic random windows."""

    def __init__(self, path: str, batch: int, seq: int, seed: int = 0,
                 shard_id: int = 0, n_shards: int = 1):
        _check_shards(batch, n_shards)
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        if len(self.tokens) <= seq + 1:
            raise ValueError(f"corpus too small: {len(self.tokens)} tokens for "
                             f"windows of {seq + 1}")
        self.batch = batch // n_shards
        self.seq = seq
        self.st = PipelineState(0, seed, shard_id, n_shards)

    def state(self) -> Dict:
        return self.st.to_dict()

    def restore(self, d: Dict) -> None:
        self.st = PipelineState.from_dict(d)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.st.seed, self.st.shard_id,
                                    self.st.step]))
        starts = rng.integers(0, len(self.tokens) - self.seq - 1,
                              size=self.batch)
        rows = np.stack([np.asarray(self.tokens[s:s + self.seq + 1])
                         for s in starts])
        self.st.step += 1
        return {"inputs": rows[:, :-1], "labels": rows[:, 1:]}


class Prefetcher:
    """Bounded background prefetch (jumbo-batch queue with backpressure)."""

    def __init__(self, source, prefetch: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            batch = self.source.next_batch()
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next_batch(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
