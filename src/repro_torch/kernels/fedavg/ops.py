"""Public op: eq. 14 over a flat (R, N, L) buffer, dense or int8.

A CPU tensor runs the plain twin (``ref.py``); a CUDA tensor launches the
hand-written kernel (``kernel.py``) or raises, unless the caller selected
the twins (``kernels.common.plain_twins``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import costed, op_cost, use_twin
from repro_torch.kernels.fedavg.kernel import (fedavg_batched_cuda,
                                               fedavg_batched_q8_cuda)
from repro_torch.kernels.fedavg.ref import fedavg_batched_q8_ref, fedavg_batched_ref
from repro_torch.kernels.quantize.ref import TILE


def fedavg_cost(r: int, n: int, l: int) -> dict:
    """Eq. 14 over (R, N, L): the updates and weights read once, the means
    written once; a multiply-add per update element, a division per mean."""
    return op_cost(flops=2 * r * n * l + r * l, bytes_accessed=4 * (r * n * l + r * n + r * l),
                   launches=int(r * l > 0))


def fedavg_q8_cost(r: int, n: int, lp: int) -> dict:
    """Eq. 14 over (R, N, Lp) int8 codes: one byte a code, a scale a tile,
    the weights, the (R, Lp) means; a dequantize multiply and a
    multiply-add per code, a division per mean."""
    tiles = lp // TILE
    return op_cost(flops=3 * r * n * lp + r * lp,
                   bytes_accessed=r * n * lp + 4 * (r * n * tiles + r * n + r * lp),
                   launches=int(r * lp > 0))


@costed("fedavg", lambda updates, weights: fedavg_cost(*updates.shape))
def fedavg_flat_batched(updates: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """updates (R, N, L), weights (R, N) -> (R, L) fp32.  An all-zero
    weight row gives a zero row."""
    if use_twin(updates):
        return fedavg_batched_ref(updates, weights)
    return fedavg_batched_cuda(updates, weights)


def fedavg_flat(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """updates (N, L), weights (N,) -> (L,) fp32: one session."""
    return fedavg_flat_batched(updates[None], weights[None])[0]


@costed("fedavg_q8", lambda q, scales, weights: fedavg_q8_cost(*q.shape))
def fedavg_flat_batched_q8(q: torch.Tensor, scales: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """q (R, N, Lp) int8 wire payload, scales (R, N, Lp / 1024) fp32,
    weights (R, N) -> (R, Lp) fp32: ``fedavg_flat_batched`` of the
    dequantized payload, without the fp32 (R, N, Lp) block on the card.
    Callers slice ``[:, :P]`` to drop the padding (which averages to 0)."""
    if use_twin(q):
        return fedavg_batched_q8_ref(q, scales, weights)
    return fedavg_batched_q8_cuda(q, scales, weights)
