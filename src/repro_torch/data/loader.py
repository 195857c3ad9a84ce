"""Minimal batching utilities, numpy-side (port of ``repro.data.loader``,
copied: it has no jax in it)."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def train_test_split(x: np.ndarray, y: np.ndarray, test_frac: float = 0.2, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    n_test = int(len(x) * test_frac)
    te, tr = idx[:n_test], idx[n_test:]
    return (x[tr], y[tr]), (x[te], y[te])


def batch_iterator(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0,
                   drop_remainder: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch of shuffled minibatches."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    end = (len(x) // batch_size) * batch_size if drop_remainder else len(x)
    for s in range(0, max(end, batch_size if not drop_remainder else 0), batch_size):
        sel = idx[s : s + batch_size]
        if len(sel) == 0 or (drop_remainder and len(sel) < batch_size):
            return
        yield x[sel], y[sel]


def pad_to_batch(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Pad (repeat) a client shard so it is a multiple of batch_size."""
    n = len(x)
    if n % batch_size == 0 and n > 0:
        return x, y
    reps = int(np.ceil(max(batch_size, n) / max(n, 1)))
    x = np.concatenate([x] * reps)[: max(batch_size, (n // batch_size + 1) * batch_size)]
    y = np.concatenate([y] * reps)[: len(x)]
    return x, y
