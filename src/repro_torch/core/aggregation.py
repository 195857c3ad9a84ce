"""Model-update aggregation (paper eq. 14: FedAvg over contributors).

Two forms, as in ``repro.core.aggregation``:

* **List form** (:func:`fedavg`, :func:`masked_fedavg`): the received
  update trees are flattened into ONE (1, N, P) buffer and averaged by ONE
  launch of the eq. 14 op (``repro_torch.kernels.fedavg.ops``): the
  hand-written kernel on the card, its plain twin on the CPU.
* **Stacked form** (:func:`masked_weighted_mean_stacked`): one tree whose
  leaves carry a leading contributor axis, plain torch.

:func:`delta` / :func:`apply_delta` are the update-as-difference helpers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.fedavg.ops import fedavg_flat_batched
from repro_torch.utils.tree import flatten_to_vector, tree_map, unflatten_from_vector


def fedavg(updates: Sequence, weights: Optional[Sequence[float]] = None):
    """Paper eq. (14): ``sum_n w_n u_n / max(sum_n w_n, 1e-9)`` over the
    update trees in one launch.  ``weights`` default to uniform (the CFL
    server weighs clients by their sample counts)."""
    if not updates:
        raise ValueError("fedavg needs at least one update")
    return masked_fedavg(updates, np.ones((len(updates),), np.float32), weights)


def masked_fedavg(updates: Sequence, mask: Sequence[float],
                  weights: Optional[Sequence[float]] = None):
    """FedAvg over the contributors selected by the participation mask:
    ``sum_n m_n w_n u_n / max(sum_n m_n w_n, 1e-9)`` in one launch."""
    if not updates:
        raise ValueError("masked_fedavg needs at least one update")
    w = np.asarray(mask, np.float32)
    if weights is not None:
        w = w * np.asarray(weights, np.float32)
    stacked = torch.stack([flatten_to_vector(u)[0] for u in updates])
    w_t = torch.from_numpy(np.ascontiguousarray(w)).to(stacked.device)
    avg = fedavg_flat_batched(stacked[None], w_t[None])[0]
    return unflatten_from_vector(avg, updates[0])


def masked_weighted_mean_stacked(stacked, mask, weights=None):
    """Leaves of ``stacked`` have shape (N_c, ...): the masked weighted
    mean over that axis, ``sum(w * leaf) / (sum(w) + 1e-9)``."""
    w = torch.as_tensor(mask, dtype=torch.float32)
    if weights is not None:
        w = w * torch.as_tensor(weights, dtype=torch.float32)

    def _avg(leaf):
        wl = w.to(leaf.device)
        wb = wl.reshape((-1,) + (1,) * (leaf.dim() - 1))
        return (torch.sum(leaf.to(torch.float32) * wb, dim=0)
                / (torch.sum(wl) + 1e-9)).to(leaf.dtype)

    return tree_map(_avg, stacked)


def delta(new_params, old_params):
    """Model update as a delta (what contributors transmit when the
    requester already holds a base model)."""
    return tree_map(torch.subtract, new_params, old_params)


def apply_delta(params, d, scale: float = 1.0):
    return tree_map(lambda p, u: p + scale * u, params, d)
