"""Plain PyTorch eq. 14, dense and on the int8 wire format: the spec
of ``csrc/fedavg.cu``."""

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


def fedavg_batched_q8_ref(q: torch.Tensor, scales: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """q (R, N, Lp) int8, scales (R, N, Lp / tile) fp32, weights (R, N)
    -> (R, Lp) fp32: dequantize (``q * scale``), then eq. 14.  The spec of
    the fused ``fedavg_q8_kernel``."""
    r, n, lp = q.shape
    tile = lp // scales.shape[-1]
    u = (q.to(torch.float32).reshape(r, n, -1, tile)
         * scales[..., None]).reshape(r, n, lp)
    return fedavg_batched_ref(u, weights)
