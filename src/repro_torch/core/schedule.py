"""Counter-based minibatch schedule (port of ``repro.core.schedule``).

Every sample index ``i`` of epoch ``e`` gets the uint32 sort key
``bits(fold_in(fold_in(PRNGKey(seed), e), i))``, reproduced bit for bit by
:mod:`repro_torch.core.prng`.  An epoch's order is the stable argsort of
those keys with the positions past the true shard size forced last (the
``0xFFFFFFFF`` sentinel), chopped into ``steps`` batches of ``batch``
indices with a 0/1 weight per sample.  Shards holding a full batch drop
the last partial batch; smaller shards run as one padded batch whose
padding weighs zero.

The plan is computed on the host (CPU tensors), like the JAX loop engine
does; callers move ``idx`` to their device once per fit.  The fleet plans
all its lanes at once with :func:`lane_plans`.  Requester fit in
round ``r`` uses ``seed = cfg.seed + r``; contributor refresh uses
``seed = cfg.seed + device_id``.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng

_UINT32_MAX = 0xFFFFFFFF


def index_scores(key: torch.Tensor, n: int, *, partitionable: bool = True):
    """(n,) uint32 (in int64) per-sample sort keys; prefix-stable in ``n``."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    return prng.bits(prng.fold_in(key, idx), partitionable=partitionable)


def epoch_scores(seed: int, epochs: int, n_pad: int, *,
                 partitionable: bool = True):
    """(epochs, n_pad) uint32 (in int64) scores for one fit call."""
    base = prng.prng_key(seed)
    keys = prng.fold_in(base, torch.arange(epochs, dtype=torch.int64))
    idx = torch.arange(n_pad, dtype=torch.int64)
    sample_keys = prng.fold_in(keys[:, None, :], idx[None, :])
    return prng.bits(sample_keys, partitionable=partitionable)


def plan_from_scores(scores: torch.Tensor, n: int, batch: int, steps: int):
    """Per-epoch scores -> ``idx`` (epochs, steps, batch) int64 gather
    indices and ``w`` (epochs, steps, batch) fp32 sample weights.
    Positions past the usable budget (``(n // batch) * batch``, or ``n``
    for a sub-batch shard) get weight 0 and index 0."""
    idx, w = lane_plans(scores, [n], batch, steps)
    return idx[0], w[0]


def lane_plans(scores: torch.Tensor, n, batch: int, steps: int):
    """The plans of R lanes at once (:func:`plan_from_scores` is the case
    R = 1).  ``scores`` is (epochs, n_pad), shared by every lane (the
    fleet's requesters in a static lockstep world score with ``seed + r``),
    or (R, epochs, n_pad), one row per lane (the refresh rows' own seeds);
    ``n`` holds the R true shard sizes.  Returns ``idx, w`` of shape
    (R, epochs, steps, batch): one batched stable argsort, no Python loop
    over lanes."""
    n = torch.as_tensor(n, dtype=torch.int64)
    lanes = n.shape[0]
    if scores.dim() == 2:
        scores = scores.expand(lanes, *scores.shape)
    epochs, n_pad = scores.shape[1:]
    take = steps * batch
    pos = torch.arange(n_pad, dtype=torch.int64)
    masked = torch.where(pos[None, None, :] < n[:, None, None], scores,
                         torch.full_like(scores, _UINT32_MAX))
    perm = torch.argsort(masked, dim=-1, stable=True)   # valid first
    if take > n_pad:
        perm = torch.nn.functional.pad(perm, (0, take - n_pad))
    n_limit = torch.where(n >= batch, (n // batch) * batch, n)
    w = (torch.arange(take)[None, :] < n_limit[:, None]).to(torch.float32)
    idx = torch.where(w[:, None, :] > 0, perm[..., :take], torch.zeros_like(perm[..., :take]))
    return (idx.reshape(lanes, epochs, steps, batch),
            w.reshape(lanes, 1, steps, batch).expand(lanes, epochs, steps, batch).clone())


def fit_steps(n: int, batch: int) -> int:
    """Step count for a shard: drop-last full batches, or one padded step
    when the shard is smaller than a batch."""
    return max(n // batch, 1)


def minibatch_plan(seed: int, *, epochs: int, n: int, batch: int,
                   partitionable: bool = True):
    """The whole fit plan: ``idx, w`` of shape
    (epochs, fit_steps(n, batch), batch), on the CPU."""
    scores = epoch_scores(seed, epochs, n, partitionable=partitionable)
    return plan_from_scores(scores, n, batch, fit_steps(n, batch))
