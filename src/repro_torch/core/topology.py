"""Aggregation strategies and mixing matrices (the part of
``repro.core.topology`` that does not use a device mesh; the mesh-only
fields of ``AggregationStrategy`` come with slice H).

* :func:`contributor_round_mask` / :func:`dynamic_round_weights` — which
  contributors feed the requester's eq. (14) each round, static or under
  churn;
* :func:`group_mixing_matrix` (numpy) / :func:`mixing_matrix_torch` —
  the row-stochastic (C, C) matrix ``M`` of a client-stacked round,
  ``params' = M @ params``, applied by :func:`apply_mixing`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.utils.tree import tree_map

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


def dynamic_round_weights(member, rank, strategy: Optional[AggregationStrategy] = None):
    """Per-round aggregation weights under churn: ``member`` (..., N) bool
    (the re-negotiated contract set) and ``rank`` (..., N) int utility
    ranks (0 = best) -> (..., N) fp32.  ``None`` / ``cfl`` / ``dfl_mesh``:
    every member; ``dfl_ring``: the best and worst ranked members
    (everyone when <= 2 members); ``enfed`` with ``neighborhood_size`` k:
    the k best-ranked members (0 = all)."""
    member = torch.as_tensor(member).to(torch.bool)
    rank = torch.as_tensor(rank).to(torch.int32)
    w = member
    if strategy is not None:
        if strategy.kind == "dfl_ring":
            count = torch.sum(member, dim=-1, keepdim=True).to(torch.int32)
            ring = (rank == 0) | (rank == count - 1)
            w = member & torch.where(count > 2, ring, True)
        elif strategy.kind == "enfed" and strategy.neighborhood_size:
            w = member & (rank < strategy.neighborhood_size)
    return w.to(torch.float32)


def group_mixing_matrix(num_clients: int, strategy: AggregationStrategy,
                        mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Row-stochastic (C, C) mixing matrix M: params' = M @ params.

    cfl / dfl_mesh: global masked mean rows.
    dfl_ring: one gossip step — (self + left + right) / participating.
    enfed: block-diagonal neighborhood masked means (nearby devices only).
    """
    C = num_clients
    m = np.ones(C, np.float32) if mask is None else np.asarray(mask, np.float32)
    M = np.zeros((C, C), np.float32)
    if strategy.kind in ("cfl", "dfl_mesh"):
        row = m / max(m.sum(), 1e-9)
        M[:] = row[None, :]
    elif strategy.kind == "dfl_ring":
        for i in range(C):
            neigh = [i, (i - 1) % C, (i + 1) % C]
            w = np.array([m[j] for j in neigh], np.float32)
            if w.sum() <= 0:
                M[i, i] = 1.0
                continue
            w = w / w.sum()
            for j, wj in zip(neigh, w):
                M[i, j] += wj
    elif strategy.kind == "enfed":
        k = strategy.neighborhood_size or C
        for g0 in range(0, C, k):
            sl = slice(g0, min(g0 + k, C))
            mg = m[sl]
            if mg.sum() <= 0:
                M[sl, sl] = np.eye(sl.stop - sl.start, dtype=np.float32)
                continue
            row = mg / mg.sum()
            M[sl, sl] = row[None, :]
    elif strategy.kind == "none":
        M = np.eye(C, dtype=np.float32)
    else:
        raise ValueError(strategy.kind)
    # non-participants keep their own params (mask row override)
    for i in range(C):
        if m[i] == 0 and strategy.kind in ("cfl", "dfl_mesh", "enfed"):
            M[i] = 0.0
            M[i, i] = 1.0
    return M


def mixing_matrix_torch(num_clients: int, strategy: AggregationStrategy, mask=None,
                        device=None) -> torch.Tensor:
    """:func:`group_mixing_matrix` as fp32 tensor operations on ``device``
    (the mask may be a tensor there): the port of ``mixing_matrix_jnp``.
    Non-participants keep their own params (identity rows) for
    cfl / dfl_mesh / enfed."""
    C = num_clients
    m = (torch.ones((C,), dtype=torch.float32, device=device) if mask is None
         else torch.as_tensor(mask, device=device).to(torch.float32))
    device = m.device
    eye = torch.eye(C, dtype=torch.float32, device=device)
    kind = strategy.kind
    if kind == "none":
        return eye
    if kind in ("cfl", "dfl_mesh"):
        row = m / torch.clamp_min(m.sum(), 1e-9)
        return torch.where((m > 0)[:, None], row.expand(C, C), eye)
    if kind == "dfl_ring":
        idx = torch.arange(C, device=device)
        nb = torch.stack([idx, (idx - 1) % C, (idx + 1) % C], dim=1)   # (C, 3)
        w = m[nb]
        tot = w.sum(dim=1, keepdim=True)
        w = torch.where(tot > 0, w / torch.clamp_min(tot, 1e-9), torch.zeros_like(w))
        M = torch.zeros((C, C), dtype=torch.float32, device=device).index_put_(
            (idx[:, None].expand(C, 3), nb), w, accumulate=True)
        return torch.where((tot[:, 0] > 0)[:, None], M, eye)
    if kind == "enfed":
        k = strategy.neighborhood_size or C
        group = torch.arange(C, device=device) // k
        same = (group[:, None] == group[None, :]).to(torch.float32)
        M = same * m[None, :]
        tot = M.sum(dim=1, keepdim=True)
        M = torch.where(tot > 0, M / torch.clamp_min(tot, 1e-9), eye)
        return torch.where((m > 0)[:, None], M, eye)
    raise ValueError(kind)


def apply_mixing(stacked_params, M):
    """params' = M @ params over the leading client axis of every leaf: a
    plain fp32 product, as the reference computes it outside any kernel."""
    def mix(leaf):
        Mt = torch.as_tensor(M, dtype=torch.float32, device=leaf.device)
        flat = leaf.reshape(leaf.shape[0], -1).to(torch.float32)
        return (Mt @ flat).reshape(leaf.shape).to(leaf.dtype)

    return tree_map(mix, stacked_params)
