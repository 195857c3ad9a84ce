"""Synthetic LM token pipeline for the LM zoo's training driver (copy of
``repro.data.tokens``, numpy only, so the port's batches equal the
reference's bit for bit).

Generates Zipf-distributed token streams with short-range Markov structure
so a model has something non-trivial to fit in the end-to-end example.
``synthetic_token_batches`` yields {tokens, labels} dicts of int32 numpy
arrays; the caller moves them to its device.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def _zipf_probs(vocab: int, s: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-s)
    return p / p.sum()


def synthetic_token_batches(vocab_size: int, batch_size: int, seq_len: int,
                            num_batches: int, seed: int = 0,
                            markov_weight: float = 0.5) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    base = _zipf_probs(min(vocab_size, 4096))
    sub = len(base)
    # sparse Markov successor table over the frequent sub-vocab
    succ = rng.integers(0, sub, size=(sub, 4))
    for _ in range(num_batches):
        toks = np.empty((batch_size, seq_len + 1), np.int64)
        cur = rng.choice(sub, size=batch_size, p=base)
        toks[:, 0] = cur
        for t in range(1, seq_len + 1):
            follow = rng.random(batch_size) < markov_weight
            nxt_markov = succ[cur, rng.integers(0, 4, size=batch_size)]
            nxt_iid = rng.choice(sub, size=batch_size, p=base)
            cur = np.where(follow, nxt_markov, nxt_iid)
            toks[:, t] = cur
        yield {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
