"""Plain PyTorch Byzantine-robust statistics over the flat round state:
the spec of ``csrc/robust.cu`` (port of ``repro.kernels.robust.ref``).

Formulated with ``sort`` / ``argmax`` / ``take_along_dim``, independently
of the kernels' register scans and sorting network.  The trimmed mean
drops the FIRST max/min instance on value ties, as ``argmax``/``argmin``
return the first index.  Each ``*_q8`` twin dequantizes (``q * scale``,
the exact wire inverse) and runs the dense twin, so fused-q8 and
dense-on-dequantized agree bitwise by construction.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.quantize.ref import dequantize_batched_ref


def trimmed_mean_batched_ref(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """updates (R, N, L), weights (R, N) -> (R, L) fp32.

    Per coordinate, among the active (w > 0) contributors, the single
    largest and then the single smallest remaining instance drop out, and
    the rest is weight-averaged: ``sum w u / max(sum w, 1e-9)``.  With
    <= 2 active it is the plain weighted mean; with 0 active it is 0.
    """
    u = updates.to(torch.float32)
    w = weights.to(torch.float32)
    n = u.shape[1]
    act = (w > 0.0)[:, :, None]
    wb = torch.where(act, w[:, :, None], 0.0)
    m = act.sum(dim=1, keepdim=True)
    n_idx = torch.arange(n, device=u.device)[None, :, None]
    inf = torch.tensor(float("inf"), device=u.device)
    one_max = n_idx == torch.argmax(torch.where(act, u, -inf), dim=1, keepdim=True)
    one_min = n_idx == torch.argmin(torch.where(act & ~one_max, u, inf), dim=1,
                                    keepdim=True)
    w_use = torch.where((m > 2) & (one_max | one_min), 0.0, wb)
    num = torch.sum(w_use * torch.where(act, u, 0.0), dim=1)
    den = torch.clamp_min(torch.sum(w_use, dim=1), 1e-9)
    return num / den


def median_batched_ref(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """updates (R, N, L), weights (R, N) -> (R, L) fp32.

    Per coordinate, the median of the active contributors' values (the
    mean of ranks ``(m - 1) // 2`` and ``m // 2``; weights gate activity
    only); 0 active gives 0.
    """
    u = updates.to(torch.float32)
    act = weights.to(torch.float32) > 0.0
    m = act.sum(dim=1)
    srt = torch.sort(torch.where(act[:, :, None], u, float("inf")), dim=1).values
    lo = torch.clamp_min(torch.div(m - 1, 2, rounding_mode="floor"), 0)[:, None, None]
    hi = torch.clamp_min(m // 2, 0)[:, None, None]
    shape = (u.shape[0], 1, u.shape[2])
    vlo = torch.take_along_dim(srt, lo.expand(shape), dim=1)[:, 0]
    vhi = torch.take_along_dim(srt, hi.expand(shape), dim=1)[:, 0]
    return torch.where((m > 0)[:, None], 0.5 * (vlo + vhi), 0.0)


def sqnorm_batched_ref(updates: torch.Tensor) -> torch.Tensor:
    """updates (R, N, L) -> (R, N) fp32 squared L2 norms."""
    u = updates.to(torch.float32)
    return torch.sum(u * u, dim=-1)


def trimmed_mean_batched_q8_ref(q, scales, weights):
    """q (R, N, Lp) int8, scales (R, N, Lp / 1024): the dense twin on the
    dequantized buffer."""
    return trimmed_mean_batched_ref(dequantize_batched_ref(q, scales), weights)


def median_batched_q8_ref(q, scales, weights):
    return median_batched_ref(dequantize_batched_ref(q, scales), weights)


def sqnorm_batched_q8_ref(q, scales):
    return sqnorm_batched_ref(dequantize_batched_ref(q, scales))
