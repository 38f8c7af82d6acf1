"""Synthetic Uniref50-shaped training rows, made from a seed.

Copied from ``bench.py:synthetic_uniref_batch`` (the JAX package's own
throughput bench trains on these rows).
"""

from __future__ import annotations

import numpy as np


def synthetic_uniref_batch(rng: np.random.Generator, batch: int, seq_len: int):
    """Uniref50-shaped rows: '# ' + uppercase residues, +1 offset, BOS col,
    pad tail: the layout the tfrecord collate emits, ``(batch, seq_len + 1)``
    int32."""
    out = np.zeros((batch, seq_len + 1), dtype=np.int32)
    for i in range(batch):
        n = int(rng.integers(seq_len // 2, seq_len + 1))
        residues = rng.integers(ord("A"), ord("Z") + 1, size=n - 2)
        row = np.concatenate(([ord("#"), ord(" ")], residues)) + 1
        out[i, 1 : 1 + n] = row
    return out
