"""Aggregation strategies of the requester-centric engines (the part of
``repro.core.topology`` that does not use a device mesh; the mesh-only
fields of ``AggregationStrategy`` come with slice H)."""

from __future__ import annotations

import dataclasses
import numpy as np

STRATEGIES = ("cfl", "dfl_mesh", "dfl_ring", "enfed", "none")


@dataclasses.dataclass(frozen=True)
class AggregationStrategy:
    kind: str = "cfl"
    neighborhood_size: int = 0     # enfed: best-utility contributors fed (0 = all)

    def __post_init__(self):
        if self.kind not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.kind!r}; one of {STRATEGIES}")


def contributor_round_mask(n_contrib: int, strategy: AggregationStrategy) -> np.ndarray:
    """Which *signed* contributors feed the requester's eq. (14) each round.

    Contributors are indexed in contract order (best utility first):

    * ``cfl`` / ``dfl_mesh`` / ``none`` — every signed contributor;
    * ``dfl_ring`` — the two ring neighbours (ranks 0 and n-1; with <= 2
      contributors the ring is the mesh);
    * ``enfed`` — the ``neighborhood_size`` best-utility contributors
      (0 = all).
    """
    m = np.ones((n_contrib,), np.float32)
    if n_contrib <= 0:
        return m
    if strategy.kind == "dfl_ring" and n_contrib > 2:
        m[:] = 0.0
        m[0] = 1.0
        m[n_contrib - 1] = 1.0
    elif strategy.kind == "enfed" and strategy.neighborhood_size:
        k = min(strategy.neighborhood_size, n_contrib)
        m[k:] = 0.0
    return m
