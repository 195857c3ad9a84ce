"""Launchers of the Byzantine-robust kernels (``csrc/robust.cu``).

Each replaces one Pallas entry point of ``repro.kernels.robust.kernel``:

* ``trimmed_mean_cuda`` / ``trimmed_mean_q8_cuda``: ``trimmed_mean_batched_pallas``
  and ``trimmed_mean_batched_q8_pallas``;
* ``median_cuda`` / ``median_q8_cuda``: ``median_batched_pallas`` and
  ``median_batched_q8_pallas``;
* ``sqnorm_cuda`` / ``sqnorm_q8_cuda``: ``sqnorm_batched_pallas`` and
  ``sqnorm_batched_q8_pallas``.

Each has its own launch counter.  The column kernels take any number of
contributors N: up to ``MAX_N`` a body with N fixed at compile time holds
a contributor's values in registers, past it a body with a run-time N (its
own counters, ``*_any_launches``, count the launches that ran it) re-reads
them (the trimmed mean) or stages them in shared memory (the median; past
``MEDIAN_SHARED_N`` in a scratch buffer).  ``_any_n=True`` runs the
run-time body at any N: the tests hold it bit for bit against the
templated one.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_args, current_stream
from repro_torch.kernels.quantize.ref import TILE

MAX_N = 16   # the largest N of the templated column bodies (kMaxN of csrc/robust.cu)
MEDIAN_SHARED_N = 232_448 // (4 * 32)   # N of a one-warp median tile (kMedianSharedN): 1,816
F32, I8 = torch.float32, torch.int8

trimmed_mean_launches = 0
trimmed_mean_q8_launches = 0
median_launches = 0
median_q8_launches = 0
sqnorm_launches = 0
sqnorm_q8_launches = 0
trimmed_mean_any_launches = 0
trimmed_mean_q8_any_launches = 0
median_any_launches = 0
median_q8_any_launches = 0

_COLUMN_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_COLUMN_Q8_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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


def _scratch(kind: str, like: torch.Tensor, r: int, n: int, l: int):
    """The median's scratch buffer past a one-warp shared tile, else None."""
    if kind == "median" and n > MEDIAN_SHARED_N:
        return like.new_empty((r, n, l), dtype=F32)
    return None


def _check_columns(n: int) -> None:
    if n < 1:
        raise ValueError(f"the robust column kernels need N >= 1 contributors (got N = {n})")


def _launch(kind: str, ptrs, like, r: int, n: int, l: int, dev: int, any_n: bool) -> bool:
    """One column launch (``ptrs`` the inputs' and the output's pointers);
    returns whether the run-time-N body ran."""
    scratch = _scratch(kind.removesuffix("_q8"), like, r, n, l)
    _C[kind](*ptrs, None if scratch is None else scratch.data_ptr(), r, n, l, int(any_n),
             current_stream(dev))
    return any_n or n > MAX_N


def _columns(kind: str, updates: torch.Tensor, weights: torch.Tensor, any_n: bool):
    """(out, whether the kernel was launched, whether its run-time-N body ran)."""
    r, n, l = _updates_shape(updates)
    _check_columns(n)
    dev = check_args(("updates", updates, F32, None), ("weights", weights, F32, (r, n)))
    out = updates.new_empty((r, l))
    if not (r and l):
        return out, False, False
    ptrs = (updates.data_ptr(), weights.data_ptr(), out.data_ptr())
    return out, True, _launch(kind, ptrs, updates, r, n, l, dev, any_n)


def _columns_q8(kind: str, q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor,
                any_n: bool):
    r, n, lp = _wire_shape(q)
    _check_columns(n)
    dev = check_args(("q", q, I8, None), ("scales", scales, F32, (r, n, lp // TILE)),
                     ("weights", weights, F32, (r, n)))
    out = scales.new_empty((r, lp))
    if not (r and lp):
        return out, False, False
    ptrs = (q.data_ptr(), scales.data_ptr(), weights.data_ptr(), out.data_ptr())
    return out, True, _launch(kind + "_q8", ptrs, scales, r, n, lp, dev, any_n)


def trimmed_mean_cuda(updates: torch.Tensor, weights: torch.Tensor, *,
                      _any_n: bool = False) -> torch.Tensor:
    """updates (R, N, L) fp32, weights (R, N) fp32, contiguous on one CUDA
    device -> (R, L) fp32 per-coordinate trimmed means."""
    global trimmed_mean_launches, trimmed_mean_any_launches
    out, launched, any_body = _columns("trimmed_mean", updates, weights, _any_n)
    trimmed_mean_launches += launched
    trimmed_mean_any_launches += any_body
    return out


def trimmed_mean_q8_cuda(q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor, *,
                         _any_n: bool = False) -> torch.Tensor:
    """q (R, N, Lp) int8, scales (R, N, Lp / 1024) fp32, weights (R, N)
    -> (R, Lp) fp32: the trimmed mean of ``q * scale``."""
    global trimmed_mean_q8_launches, trimmed_mean_q8_any_launches
    out, launched, any_body = _columns_q8("trimmed_mean", q, scales, weights, _any_n)
    trimmed_mean_q8_launches += launched
    trimmed_mean_q8_any_launches += any_body
    return out


def median_cuda(updates: torch.Tensor, weights: torch.Tensor, *,
                _any_n: bool = False) -> torch.Tensor:
    """updates (R, N, L) fp32, weights (R, N) fp32 -> (R, L) fp32
    per-coordinate masked medians."""
    global median_launches, median_any_launches
    out, launched, any_body = _columns("median", updates, weights, _any_n)
    median_launches += launched
    median_any_launches += any_body
    return out


def median_q8_cuda(q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor, *,
                   _any_n: bool = False) -> torch.Tensor:
    """The masked median of ``q * scale``: (R, Lp) fp32."""
    global median_q8_launches, median_q8_any_launches
    out, launched, any_body = _columns_q8("median", q, scales, weights, _any_n)
    median_q8_launches += launched
    median_q8_any_launches += any_body
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
