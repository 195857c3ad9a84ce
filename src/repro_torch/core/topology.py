"""FL topologies: aggregation strategies, their collective schedules on a
device mesh, and mixing matrices (port of ``repro.core.topology``).

The paper's four communication regimes map onto mesh collectives:

| regime          | collective                               | bytes/round (w = update size) |
|-----------------|------------------------------------------|-------------------------------|
| CFL (FedAvg)    | all-reduce over client axes              | ~2w (bandwidth-optimal ring)  |
| DFL mesh        | all-gather + local mean                  | N*w (everyone gets everything)|
| DFL ring        | (N-1) neighbour permute hops             | (N-1)*w, neighbour links only |
| EnFed           | masked reduce within a *neighborhood*    | (k-1)*w, k = nearby devices,  |
|                 | (contiguous segment of the data axis,    | never crosses the pod axis    |
|                 | ring of permutes among contract-masked   | with ``pod_local``            |
|                 | contributors)                            |                               |

* :func:`aggregate_local` / :func:`aggregate_updates` — the collectives,
  run by every rank of the mesh (one process per rank) on its own
  client's update, over the mesh's per-axis process groups
  (``repro_torch.sharding.collectives``).  A ring hop adds in hop order,
  so a ring's sum is the reference's to the bit; an all-reduce sums in
  the backend's order.  An int8 hop's codes are the reference's; XLA may
  fuse the hop's ``acc + codes * scale`` into one multiply-add, so an int8
  ring's sum can differ from the reference's in its last bit.
* :func:`contributor_round_mask` / :func:`dynamic_round_weights` — which
  contributors feed the requester's eq. (14) each round, static or under
  churn;
* :func:`group_mixing_matrix` (numpy) / :func:`mixing_matrix_torch` —
  the row-stochastic (C, C) matrix ``M`` of a client-stacked round,
  ``params' = M @ params``, applied by :func:`apply_mixing`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding import collectives as coll
from repro_torch.utils.tree import tree_leaves, tree_map

STRATEGIES = ("cfl", "dfl_mesh", "dfl_ring", "enfed", "none")

# The ring hop's int8 scale: the reference writes max(absmax, 1e-12) / 127
# (repro/core/topology.py:92); XLA compiles the division by the constant
# as a product with fp32(1/127), and so does the port, code for code.
INV_127 = np.float32(1.0) / np.float32(127.0)


@dataclasses.dataclass(frozen=True)
class AggregationStrategy:
    kind: str = "cfl"
    client_axes: Tuple[str, ...] = ("data",)
    neighborhood_size: int = 0     # enfed: contributors per neighborhood (0 = whole axis)
    pod_local: bool = False        # enfed: never reduce across "pod" (hierarchical mode)
    # int8-compress ring hops (EnFed/DFL-ring): per-leaf absmax symmetric
    # quantization of each hop's payload, 4x fewer wire bytes, lossy
    compress: Optional[str] = None  # None | "int8"

    def __post_init__(self):
        if self.kind not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.kind!r}; one of {STRATEGIES}")
        if self.compress not in (None, "int8"):
            raise ValueError(f"compress must be None or 'int8', not {self.compress!r}")


# ---------------------------------------------------------------------------
# collective schedules on a mesh
# ---------------------------------------------------------------------------


def _client_index(axes, mesh) -> int:
    return coll.axis_index(mesh, axes)


def _quantize_hop(x, mesh, axis: str, perm):
    """One int8 hop of a leaf: quantize, send codes and scale, dequantize
    what arrives."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(torch.max(torch.abs(xf)), 1e-12) * torch.tensor(
        INV_127, device=x.device)
    qx = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    qx = coll.ppermute(qx, mesh, axis, perm)
    scale = coll.ppermute(scale, mesh, axis, perm)
    return (qx.to(torch.float32) * scale).to(x.dtype)


def _ring_sum(val, mesh, axis: str, n: int, group: int, compress: Optional[str] = None):
    """Sum within contiguous groups of size ``group`` along ``axis`` using
    neighbour permute hops only (EnFed 'nearby devices' = adjacent links):
    ``group - 1`` hops, the running sum added in hop order.

    ``compress="int8"`` quantizes each hop's payload (per-leaf absmax
    symmetric int8 + one fp32 scale) before the permute."""
    perm = [(i, (i // group) * group + ((i % group) + 1) % group) for i in range(n)]
    def hop(tree):
        if compress != "int8":
            return tree_map(lambda x: coll.ppermute(x, mesh, axis, perm), tree)
        return tree_map(lambda x: _quantize_hop(x, mesh, axis, perm), tree)

    acc, cur = val, val
    for _ in range(group - 1):
        cur = hop(cur)
        acc = tree_map(torch.add, acc, cur)
    return acc


def _full_ring_allreduce(tree, mesh, axis: str, n: int, compress=None):
    return _ring_sum(tree, mesh, axis, n, n, compress)


def _psum(tree, mesh, axes):
    return tree_map(lambda x: coll.all_reduce(x, mesh, axes), tree)


def aggregate_local(u, m, mesh, strategy: AggregationStrategy):
    """This rank's aggregation: ``u`` is its client's update tree, ``m`` the
    per-client participation vector (the same on every rank).  Every rank
    of the mesh calls it together (ranks that share a client along the
    other axes run the same schedule on the same values)."""
    axes = tuple(strategy.client_axes)
    idx = _client_index(axes, mesh)
    my = m[idx]
    sizes = {ax: coll.axes_size(mesh, ax) for ax in axes}

    def finish(summed, tot):
        return tree_map(lambda x: x / torch.clamp_min(tot, 1e-9), summed)

    if strategy.kind == "cfl":
        tot = coll.all_reduce(my, mesh, axes)
        summed = _psum(tree_map(lambda x: x * my, u), mesh, axes)
        return finish(summed, tot)

    if strategy.kind == "dfl_mesh":
        # every node gathers every node's update, then averages locally
        def leaf(x):
            g = coll.all_gather(x * my, mesh, axes[-1])
            for ax in axes[:-1]:
                g = coll.all_gather(g, mesh, ax)
            return torch.sum(g, dim=tuple(range(len(axes))))
        tot = coll.all_reduce(my, mesh, axes)
        return finish(tree_map(leaf, u), tot)

    if strategy.kind == "dfl_ring":
        # exact consensus via n-1 neighbour hops along the innermost axis
        ax = axes[-1]
        n = sizes[ax]
        summed = _full_ring_allreduce(tree_map(lambda x: x * my, u), mesh, ax, n,
                                      strategy.compress)
        tot = _full_ring_allreduce(my, mesh, ax, n)
        if len(axes) > 1:  # hierarchical: finish over the outer axes
            summed = _psum(summed, mesh, axes[:-1])
            tot = coll.all_reduce(tot, mesh, axes[:-1])
        return finish(summed, tot)

    if strategy.kind == "enfed":
        # opportunistic: masked reduce among nearby devices only
        ax = axes[-1]
        n = sizes[ax]
        k = strategy.neighborhood_size or n
        masked = tree_map(lambda x: x * my, u)
        if k >= n:
            summed = _psum(masked, mesh, ax)
            tot = coll.all_reduce(my, mesh, ax)
        else:
            summed = _ring_sum(masked, mesh, ax, n, k, strategy.compress)
            tot = _ring_sum(my, mesh, ax, n, k)
        if len(axes) > 1 and not strategy.pod_local:
            summed = _psum(summed, mesh, axes[:-1])
            tot = coll.all_reduce(tot, mesh, axes[:-1])
        return finish(summed, tot)

    raise ValueError(strategy.kind)


def aggregate_updates(updates, mesh, strategy: AggregationStrategy, mask=None):
    """Aggregate this rank's client update tree over the client axes.

    ``mask`` is the per-client participation vector of length
    prod(client-axis sizes), the same on every rank; None = all
    participate.  Returns this rank's block of the reference's
    client-stacked result: every leaf gains a leading axis of 1 holding
    this client's post-aggregation value (the same for the consensus
    strategies, per neighborhood for opportunistic EnFed).
    :func:`gather_clients` puts the full ``(C, ...)`` stack together."""
    if strategy.kind == "none":
        return updates
    axes = tuple(strategy.client_axes)
    if mask is None:
        dev = tree_leaves(updates)[0].device
        mask = torch.ones((coll.axes_size(mesh, axes),), dtype=torch.float32, device=dev)
    out = aggregate_local(updates, mask, mesh, strategy)
    return tree_map(lambda x: x[None], out)


def gather_clients(blocks, mesh, client_axes):
    """Every client's block (leading axis 1) stacked into the reference's
    ``(C, ...)`` layout, on every rank (for checks; one all-gather per
    leaf over the client axes)."""
    axes = tuple(client_axes)
    return tree_map(lambda x: coll.all_gather(x[0], mesh, axes), blocks)


# ---------------------------------------------------------------------------
# contributor-level round masks (requester-centric view, both EnFed engines)
# ---------------------------------------------------------------------------


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
