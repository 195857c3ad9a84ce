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
from repro_torch.kernels.common import check_cuda_arg
from repro_torch.kernels.quantize.ref import TILE

MAX_N = 16   # kMaxN of csrc/robust.cu

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


def _launch(name: str, argtypes, device, *args) -> None:
    fn = _build.function(name, argtypes)
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")


def _check_updates(updates: torch.Tensor):
    if updates.dim() != 3:
        raise ValueError(f"updates must be (R, N, L) (got {tuple(updates.shape)})")
    check_cuda_arg("updates", updates, torch.float32)
    return updates.shape


def _check_wire(q: torch.Tensor, scales: torch.Tensor):
    if q.dim() != 3 or q.shape[-1] % TILE:
        raise ValueError(f"q must be (R, N, Lp) with Lp % {TILE} == 0 "
                         f"(got {tuple(q.shape)})")
    r, n, lp = q.shape
    check_cuda_arg("q", q, torch.int8)
    check_cuda_arg("scales", scales, torch.float32, (r, n, lp // TILE), q.device)
    return q.shape


def _check_columns(weights: torch.Tensor, r: int, n: int, device) -> None:
    check_cuda_arg("weights", weights, torch.float32, (r, n), device)
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the robust column kernels take 1 to {MAX_N} contributors "
                         f"(MAX_N, kMaxN of csrc/robust.cu), got N = {n}")
    if r > 65535:
        raise ValueError(f"at most 65535 sessions per launch (got {r})")


def _columns(kind: str, updates: torch.Tensor, weights: torch.Tensor):
    """(out, whether the kernel was launched)."""
    r, n, l = _check_updates(updates)
    _check_columns(weights, r, n, updates.device)
    out = torch.empty((r, l), dtype=torch.float32, device=updates.device)
    if r and l:
        _launch(f"robust_{kind}_launch", _COLUMN_ARGTYPES, updates.device,
                updates.data_ptr(), weights.data_ptr(), out.data_ptr(), r, n, l)
    return out, bool(r and l)


def _columns_q8(kind: str, q: torch.Tensor, scales: torch.Tensor,
                weights: torch.Tensor):
    r, n, lp = _check_wire(q, scales)
    _check_columns(weights, r, n, q.device)
    out = torch.empty((r, lp), dtype=torch.float32, device=q.device)
    if r and lp:
        _launch(f"robust_{kind}_q8_launch", _COLUMN_Q8_ARGTYPES, q.device,
                q.data_ptr(), scales.data_ptr(), weights.data_ptr(), out.data_ptr(),
                r, n, lp)
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
    r, n, l = _check_updates(updates)
    out = torch.empty((r, n), dtype=torch.float32, device=updates.device)
    if r * n:
        _launch("robust_sqnorm_launch", _SQNORM_ARGTYPES, updates.device,
                updates.data_ptr(), out.data_ptr(), r * n, l)
        sqnorm_launches += 1
    return out


def sqnorm_q8_cuda(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q (R, N, Lp) int8, scales (R, N, Lp / 1024) fp32 -> (R, N) fp32
    squared L2 norms of ``q * scale``."""
    global sqnorm_q8_launches
    r, n, lp = _check_wire(q, scales)
    out = torch.empty((r, n), dtype=torch.float32, device=q.device)
    if r * n:
        _launch("robust_sqnorm_q8_launch", _SQNORM_Q8_ARGTYPES, q.device,
                q.data_ptr(), scales.data_ptr(), out.data_ptr(), r * n, lp)
        sqnorm_q8_launches += 1
    return out
