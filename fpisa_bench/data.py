"""Seeded synthetic token batches.

A frozen copy of ``SyntheticCorpus.batch`` in ``src/repro_torch/data/
pipeline.py`` as of commit e482e26 (numpy only): every batch is a pure
function of ``(seed, step, shard)``, a Zipf stream with repeated 8-token
motifs, so every row differs and the same seed gives the same tokens.
"""
from __future__ import annotations

import numpy as np


def token_batch(vocab_size: int, seed: int, step: int, batch_size: int, seq_len: int,
                shard: int = 0) -> np.ndarray:
    """(batch_size, seq_len) int32 token ids."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, shard]))
    v = vocab_size
    base = rng.zipf(1.3, size=(batch_size, seq_len)).astype(np.int64) % v
    motif_len = 8
    motif = rng.integers(0, v, size=(batch_size, motif_len))
    reps = seq_len // (2 * motif_len)
    for b in range(batch_size):
        for r in range(reps):
            at = 2 * r * motif_len
            base[b, at:at + motif_len] = motif[b]
    return base.astype(np.int32)
