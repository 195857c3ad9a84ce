"""Non-IID client partitioning (a numpy copy of ``repro.data.partition``;
it must produce the same arrays).

The paper distributes both datasets "non-identically" across the
requesting node and five supporting nodes.  The standard way to control
that heterogeneity is a Dirichlet(alpha) label split (lower alpha = more
skewed clients); alpha=0.5 gives a realistic moderately non-IID fleet.
"""

from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(y: np.ndarray, num_clients: int, alpha: float = 0.5,
                        seed: int = 0, min_per_client: int = 8) -> List[np.ndarray]:
    """Partition sample indices across clients with Dirichlet label skew."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    idx_by_class = [np.flatnonzero(y == c) for c in classes]
    for idx in idx_by_class:
        rng.shuffle(idx)
    client_idx = [[] for _ in range(num_clients)]
    for idx in idx_by_class:
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cid, part in enumerate(np.split(idx, cuts)):
            client_idx[cid].extend(part.tolist())
    out = []
    pool = np.arange(len(y))
    for cid in range(num_clients):
        arr = np.asarray(client_idx[cid], dtype=np.int64)
        if len(arr) < min_per_client:  # top up starved clients
            extra = rng.choice(pool, size=min_per_client - len(arr), replace=False)
            arr = np.concatenate([arr, extra])
        rng.shuffle(arr)
        out.append(arr)
    return out

