"""Public ops: Byzantine-robust aggregation over the flat round state
(port of ``repro.kernels.robust.ops``).

``robust_aggregate`` / ``robust_aggregate_q8`` are the one aggregation
entry both engines call when ``EnFedConfig.robust != "none"``: the loop
engine on its (1, N, P) stacked round, the fleet on its (R, N, P) buffer,
so every clip decision runs through the same code.

* ``"trimmed_mean"``: per-coordinate weighted trimmed mean (the extreme
  active instance at each end drops).
* ``"median"``: per-coordinate masked median (weights gate activity).
* ``"clip"``: per-contributor L2-norm clip to the masked median norm
  ``tau``: contribution ``j`` scales by ``min(1, tau / ||u_j||)``, run as
  the eq. 14 kernel on the rescaled weights plus an exact denominator
  correction.  It reports which active contributors were clipped.

A CPU tensor runs the plain twins (``ref.py``); a CUDA tensor launches the
hand-written kernels (``kernel.py``) or raises.  ``clip_factors`` and the
denominator correction are small (R, N) tensor ops on either device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import is_cpu
from repro_torch.kernels.fedavg.ops import fedavg_flat_batched, fedavg_flat_batched_q8
from repro_torch.kernels.robust import kernel as _k
from repro_torch.kernels.robust import ref as _ref

# "none" is the plain fedavg path; the engines skip this module for it
ROBUST_METHODS = ("none", "clip", "trimmed_mean", "median")


def trimmed_mean_flat_batched(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """updates (R, N, L), weights (R, N) -> (R, L) fp32."""
    if is_cpu(updates):
        return _ref.trimmed_mean_batched_ref(updates, weights)
    return _k.trimmed_mean_cuda(updates, weights)


def trimmed_mean_flat_batched_q8(q, scales, weights) -> torch.Tensor:
    """q (R, N, Lp) int8, scales (R, N, Lp / 1024), weights (R, N) -> (R, Lp)."""
    if is_cpu(q):
        return _ref.trimmed_mean_batched_q8_ref(q, scales, weights)
    return _k.trimmed_mean_q8_cuda(q, scales, weights)


def median_flat_batched(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """updates (R, N, L), weights (R, N) -> (R, L) fp32."""
    if is_cpu(updates):
        return _ref.median_batched_ref(updates, weights)
    return _k.median_cuda(updates, weights)


def median_flat_batched_q8(q, scales, weights) -> torch.Tensor:
    """q (R, N, Lp) int8, scales (R, N, Lp / 1024), weights (R, N) -> (R, Lp)."""
    if is_cpu(q):
        return _ref.median_batched_q8_ref(q, scales, weights)
    return _k.median_q8_cuda(q, scales, weights)


def l2norm_flat_batched(updates: torch.Tensor) -> torch.Tensor:
    """updates (R, N, L) -> (R, N) fp32 L2 norms (clip screening)."""
    sq = (_ref.sqnorm_batched_ref(updates) if is_cpu(updates)
          else _k.sqnorm_cuda(updates))
    return torch.sqrt(sq)


def l2norm_flat_batched_q8(q, scales) -> torch.Tensor:
    """q (R, N, Lp) int8, scales (R, N, Lp / 1024) -> (R, N) fp32 norms."""
    sq = (_ref.sqnorm_batched_q8_ref(q, scales) if is_cpu(q)
          else _k.sqnorm_q8_cuda(q, scales))
    return torch.sqrt(sq)


def _masked_median_1d(values: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """values, active (R, N) -> (R,) masked median over the active entries
    (inf for an empty row: ``min(1, tau / norm)`` then clips nothing)."""
    m = active.sum(dim=1)
    srt = torch.sort(torch.where(active, values.to(torch.float32), float("inf")),
                     dim=1).values
    lo = torch.clamp_min(torch.div(m - 1, 2, rounding_mode="floor"), 0)[:, None]
    hi = torch.clamp_min(m // 2, 0)[:, None]
    vlo = torch.take_along_dim(srt, lo, dim=1)[:, 0]
    vhi = torch.take_along_dim(srt, hi, dim=1)[:, 0]
    return 0.5 * (vlo + vhi)


def clip_factors(norms: torch.Tensor, weights: torch.Tensor):
    """norms, weights (R, N) -> ``(c, clipped, tau)``.

    ``tau`` (R,) is the masked median norm of the active contributors,
    ``c`` (R, N) the clip factor ``min(1, tau / max(norm, 1e-12))`` (1
    where inactive), ``clipped`` (R, N) bool the active contributors whose
    norm exceeds ``tau``.  At most half the active set can be clipped.
    """
    w = weights.to(torch.float32)
    norms = norms.to(torch.float32)
    active = w > 0.0
    tau = _masked_median_1d(norms, active)
    c = torch.where(active,
                    torch.clamp_max(tau[:, None] / torch.clamp_min(norms, 1e-12), 1.0),
                    1.0)
    clipped = active & (norms > tau[:, None])
    return c, clipped, tau


def _clip_combine(raw: torch.Tensor, weights: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Turn ``fedavg(u, w * c)`` into ``sum(w c u) / sum(w)``: the clip
    rescales contributions, never the normalization mass."""
    w = weights.to(torch.float32)
    s_clip = torch.clamp_min(torch.sum(w * c, dim=1), 1e-9)
    s_all = torch.clamp_min(torch.sum(w, dim=1), 1e-9)
    return raw * (s_clip / s_all)[:, None]


def _no_verdict(w: torch.Tensor) -> torch.Tensor:
    return torch.zeros(w.shape, dtype=torch.bool, device=w.device)


def robust_aggregate(updates: torch.Tensor, weights: torch.Tensor, *, method: str):
    """updates (R, N, L), weights (R, N) -> ``(agg, clipped)``: ``agg``
    (R, L) fp32, ``clipped`` (R, N) bool (all False but for ``"clip"``).
    An all-zero weight row gives a zero vector; callers keep their own."""
    w = weights.to(torch.float32)
    if method == "trimmed_mean":
        return trimmed_mean_flat_batched(updates, w), _no_verdict(w)
    if method == "median":
        return median_flat_batched(updates, w), _no_verdict(w)
    if method == "clip":
        c, clipped, _ = clip_factors(l2norm_flat_batched(updates), w)
        raw = fedavg_flat_batched(updates, w * c)
        return _clip_combine(raw, w, c), clipped
    raise ValueError(
        f"robust method must be one of {ROBUST_METHODS[1:]} (got {method!r})")


def robust_aggregate_q8(q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor, *,
                        method: str):
    """q (R, N, Lp) int8, scales (R, N, Lp / 1024), weights (R, N) ->
    ``(agg, clipped)`` with ``agg`` (R, Lp) fp32: :func:`robust_aggregate`
    of the dequantized buffer, without the fp32 (R, N, Lp) block on the
    card."""
    w = weights.to(torch.float32)
    if method == "trimmed_mean":
        return trimmed_mean_flat_batched_q8(q, scales, w), _no_verdict(w)
    if method == "median":
        return median_flat_batched_q8(q, scales, w), _no_verdict(w)
    if method == "clip":
        c, clipped, _ = clip_factors(l2norm_flat_batched_q8(q, scales), w)
        raw = fedavg_flat_batched_q8(q, scales, w * c)
        return _clip_combine(raw, w, c), clipped
    raise ValueError(
        f"robust method must be one of {ROBUST_METHODS[1:]} (got {method!r})")
