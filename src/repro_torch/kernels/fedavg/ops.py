"""Public op: eq. 14 over a flat (R, N, L) buffer, dense or int8.

A CPU tensor runs the plain twin (``ref.py``); a CUDA tensor launches the
hand-written kernel (``kernel.py``) or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import is_cpu
from repro_torch.kernels.fedavg.kernel import (fedavg_batched_cuda,
                                               fedavg_batched_q8_cuda)
from repro_torch.kernels.fedavg.ref import fedavg_batched_q8_ref, fedavg_batched_ref


def fedavg_flat_batched(updates: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """updates (R, N, L), weights (R, N) -> (R, L) fp32.  An all-zero
    weight row gives a zero row."""
    if is_cpu(updates):
        return fedavg_batched_ref(updates, weights)
    return fedavg_batched_cuda(updates, weights)


def fedavg_flat(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """updates (N, L), weights (N,) -> (L,) fp32: one session."""
    return fedavg_flat_batched(updates[None], weights[None])[0]


def fedavg_flat_batched_q8(q: torch.Tensor, scales: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """q (R, N, Lp) int8 wire payload, scales (R, N, Lp / 1024) fp32,
    weights (R, N) -> (R, Lp) fp32: ``fedavg_flat_batched`` of the
    dequantized payload, without the fp32 (R, N, Lp) block on the card.
    Callers slice ``[:, :P]`` to drop the padding (which averages to 0)."""
    if is_cpu(q):
        return fedavg_batched_q8_ref(q, scales, weights)
    return fedavg_batched_q8_cuda(q, scales, weights)
