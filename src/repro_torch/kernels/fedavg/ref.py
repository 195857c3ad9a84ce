"""Plain PyTorch eq. 14: the spec of ``csrc/fedavg.cu``."""

from __future__ import annotations

import torch


def fedavg_batched_ref(updates: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """updates (R, N, L), weights (R, N) -> (R, L) fp32:

        out[r] = sum_n w[r, n] * u[r, n] / max(sum_n w[r, n], 1e-9)
    """
    w = weights.to(torch.float32)
    num = torch.einsum("rn,rnl->rl", w, updates.to(torch.float32))
    return num / torch.clamp_min(torch.sum(w, dim=1, keepdim=True), 1e-9)

