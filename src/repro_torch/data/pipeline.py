"""Deterministic synthetic data pipeline with host-shard addressing (numpy
only; a copy of the reference's repro/data/pipeline.py, so the port and the
reference train on the same tokens).

Every batch is a pure function of ``(seed, step, shard_id)`` — a replacement
host that takes over a failed host's shard regenerates *exactly* the batches
the dead host would have produced. Background prefetch overlaps host data
generation with device compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticCorpus:
    """Zipf-ish token stream with enough structure for a loss to fall."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seed = seed

    def batch(self, step: int, shard_id: int, batch_size: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard_id])
        )
        v = self.vocab_size
        # mixture: repeated n-gram motifs (learnable) + zipf noise
        base = rng.zipf(1.3, size=(batch_size, seq_len)).astype(np.int64) % v
        motif_len = 8
        motif = rng.integers(0, v, size=(batch_size, motif_len))
        reps = seq_len // (2 * motif_len)
        for b in range(batch_size):
            for r in range(reps):
                at = 2 * r * motif_len
                base[b, at : at + motif_len] = motif[b]
        return base.astype(np.int32)


class ShardedLoader:
    """Yields per-host batches; ``shard_id``/``num_shards`` address the global
    batch slice this host owns."""

    def __init__(self, corpus: SyntheticCorpus, global_batch: int, seq_len: int,
                 shard_id: int = 0, num_shards: int = 1, prefetch: int = 2):
        assert global_batch % num_shards == 0
        self.corpus = corpus
        self.local_batch = global_batch // num_shards
        self.seq_len = seq_len
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.prefetch = prefetch

    @property
    def global_batch(self) -> int:
        return self.local_batch * self.num_shards

    def with_shard(self, new_shard_id: int) -> "ShardedLoader":
        """The same stream addressed at a different shard — the failover
        primitive: a replacement host regenerates the dead host's batches
        bit-for-bit."""
        if not 0 <= new_shard_id < self.num_shards:
            raise ValueError(f"shard {new_shard_id} out of range "
                             f"[0, {self.num_shards})")
        return ShardedLoader(self.corpus, self.global_batch, self.seq_len,
                             shard_id=new_shard_id, num_shards=self.num_shards,
                             prefetch=self.prefetch)

    def batch_at(self, step: int) -> dict:
        toks = self.corpus.batch(step, self.shard_id, self.local_batch, self.seq_len)
        return {"tokens": toks}

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            step = 0
            while not stop.is_set():
                q.put(self.batch_at(step))
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def reassign_shard(loader: ShardedLoader, new_shard_id: int) -> ShardedLoader:
    """Deterministic failover: a replacement host resumes the dead host's
    stream bit for bit (runtime/controller.py re-derives shard ownership
    from ``HealthMonitor.reassignments`` with this every step)."""
    return loader.with_shard(new_shard_id)
