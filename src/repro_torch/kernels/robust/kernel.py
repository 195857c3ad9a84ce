"""Launchers of the Byzantine-robust kernels (``csrc/robust.cu``).

Each replaces one Pallas entry point of ``repro.kernels.robust.kernel``:

* ``trimmed_mean_cuda`` / ``trimmed_mean_q8_cuda``: ``trimmed_mean_batched_pallas``
  and ``trimmed_mean_batched_q8_pallas``;
* ``median_cuda`` / ``median_q8_cuda``: ``median_batched_pallas`` and
  ``median_batched_q8_pallas``;
* ``sqnorm_cuda`` / ``sqnorm_q8_cuda``: ``sqnorm_batched_pallas`` and
  ``sqnorm_batched_q8_pallas``.

Each has its own launch counter.  The column kernels hold a contributor's
values in registers, so N is bounded by ``MAX_N``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_args, current_stream
from repro_torch.kernels.quantize.ref import TILE

MAX_N = 16   # kMaxN of csrc/robust.cu
F32, I8 = torch.float32, torch.int8

trimmed_mean_launches = 0
trimmed_mean_q8_launches = 0
median_launches = 0
median_q8_launches = 0
sqnorm_launches = 0
sqnorm_q8_launches = 0

_COLUMN_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_COLUMN_Q8_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_SQNORM_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_SQNORM_Q8_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]

_C = {name: _build.CFunction(f"robust_{name}_launch", argtypes) for name, argtypes in (
    ("trimmed_mean", _COLUMN_ARGTYPES), ("median", _COLUMN_ARGTYPES),
    ("trimmed_mean_q8", _COLUMN_Q8_ARGTYPES), ("median_q8", _COLUMN_Q8_ARGTYPES))}
_sqnorm = _build.CFunction("robust_sqnorm_launch", _SQNORM_ARGTYPES)
_sqnorm_q8 = _build.CFunction("robust_sqnorm_q8_launch", _SQNORM_Q8_ARGTYPES)


def _updates_shape(updates: torch.Tensor):
    if updates.dim() != 3:
        raise ValueError(f"updates must be (R, N, L) (got {tuple(updates.shape)})")
    return updates.shape


def _wire_shape(q: torch.Tensor):
    if q.dim() != 3 or q.shape[-1] % TILE:
        raise ValueError(f"q must be (R, N, Lp) with Lp % {TILE} == 0 "
                         f"(got {tuple(q.shape)})")
    return q.shape


def _check_columns(r: int, n: int) -> None:
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the robust column kernels take 1 to {MAX_N} contributors "
                         f"(MAX_N, kMaxN of csrc/robust.cu), got N = {n}")
    if r > 65535:
        raise ValueError(f"at most 65535 sessions per launch (got {r})")


def _columns(kind: str, updates: torch.Tensor, weights: torch.Tensor):
    """(out, whether the kernel was launched)."""
    r, n, l = _updates_shape(updates)
    dev = check_args(("updates", updates, F32, None), ("weights", weights, F32, (r, n)))
    _check_columns(r, n)
    out = updates.new_empty((r, l))
    if r and l:
        _C[kind](updates.data_ptr(), weights.data_ptr(), out.data_ptr(), r, n, l,
                 current_stream(dev))
    return out, bool(r and l)


def _columns_q8(kind: str, q: torch.Tensor, scales: torch.Tensor,
                weights: torch.Tensor):
    r, n, lp = _wire_shape(q)
    dev = check_args(("q", q, I8, None), ("scales", scales, F32, (r, n, lp // TILE)),
                     ("weights", weights, F32, (r, n)))
    _check_columns(r, n)
    out = scales.new_empty((r, lp))
    if r and lp:
        _C[kind + "_q8"](q.data_ptr(), scales.data_ptr(), weights.data_ptr(),
                         out.data_ptr(), r, n, lp, current_stream(dev))
    return out, bool(r and lp)


def trimmed_mean_cuda(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """updates (R, N, L) fp32, weights (R, N) fp32, contiguous on one CUDA
    device, N <= MAX_N -> (R, L) fp32 per-coordinate trimmed means."""
    global trimmed_mean_launches
    out, launched = _columns("trimmed_mean", updates, weights)
    if launched:
        trimmed_mean_launches += 1
    return out


def trimmed_mean_q8_cuda(q: torch.Tensor, scales: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """q (R, N, Lp) int8, scales (R, N, Lp / 1024) fp32, weights (R, N)
    -> (R, Lp) fp32: the trimmed mean of ``q * scale``."""
    global trimmed_mean_q8_launches
    out, launched = _columns_q8("trimmed_mean", q, scales, weights)
    if launched:
        trimmed_mean_q8_launches += 1
    return out


def median_cuda(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """updates (R, N, L) fp32, weights (R, N) fp32 -> (R, L) fp32
    per-coordinate masked medians."""
    global median_launches
    out, launched = _columns("median", updates, weights)
    if launched:
        median_launches += 1
    return out


def median_q8_cuda(q: torch.Tensor, scales: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """The masked median of ``q * scale``: (R, Lp) fp32."""
    global median_q8_launches
    out, launched = _columns_q8("median", q, scales, weights)
    if launched:
        median_q8_launches += 1
    return out


def sqnorm_cuda(updates: torch.Tensor) -> torch.Tensor:
    """updates (R, N, L) fp32, contiguous on a CUDA device -> (R, N) fp32
    squared L2 norms."""
    global sqnorm_launches
    r, n, l = _updates_shape(updates)
    dev = check_args(("updates", updates, F32, None))
    out = updates.new_empty((r, n))
    if r * n:
        _sqnorm(updates.data_ptr(), out.data_ptr(), r * n, l, current_stream(dev))
        sqnorm_launches += 1
    return out


def sqnorm_q8_cuda(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q (R, N, Lp) int8, scales (R, N, Lp / 1024) fp32 -> (R, N) fp32
    squared L2 norms of ``q * scale``."""
    global sqnorm_q8_launches
    r, n, lp = _wire_shape(q)
    dev = check_args(("q", q, I8, None), ("scales", scales, F32, (r, n, lp // TILE)))
    out = scales.new_empty((r, n))
    if r * n:
        _sqnorm_q8(q.data_ptr(), scales.data_ptr(), out.data_ptr(), r * n, lp,
                   current_stream(dev))
        sqnorm_q8_launches += 1
    return out
