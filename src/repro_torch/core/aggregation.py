"""Model-update aggregation (paper eq. 14: FedAvg over contributors).

``masked_fedavg`` takes the list of received update trees, flattens them
into ONE (1, N, P) buffer and makes ONE launch of the eq. 14 op
(``repro_torch.kernels.fedavg.ops``): the hand-written kernel on the card,
its plain twin on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.fedavg.ops import fedavg_flat_batched
from repro_torch.utils.tree import flatten_to_vector, unflatten_from_vector


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
