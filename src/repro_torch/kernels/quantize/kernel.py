"""Launchers of the int8 wire kernels (``csrc/quantize.cu``).

``quantize_cuda`` replaces ``repro.kernels.quantize.kernel.quantize_pallas``
(one row) and ``quantize_batched_pallas`` (B rows): one kernel serves both.
``dequantize_cuda`` replaces ``dequantize_pallas``.  ``launches`` counts the
quantize launches, ``dequantize_launches`` the dequantize launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_args, current_stream
from repro_torch.kernels.quantize.ref import TILE

launches = 0
dequantize_launches = 0

_QUANT_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_DEQUANT_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p]
_quantize = _build.CFunction("quantize_launch", _QUANT_ARGTYPES)
_dequantize = _build.CFunction("dequantize_launch", _DEQUANT_ARGTYPES)


def quantize_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L) or (L,) fp32, contiguous on a CUDA device -> (q int8
    (B, Lp) or (Lp,), scales fp32 (B, Lp / 1024) or (Lp / 1024,)), with
    Lp = L rounded up to 1024; the ragged tail quantizes as zeros."""
    global launches
    if x.dim() not in (1, 2):
        raise ValueError(f"x must be (L,) or (B, L) (got {tuple(x.shape)})")
    dev = check_args(("x", x, torch.float32, None))
    b, l = (1, x.shape[0]) if x.dim() == 1 else x.shape
    lp = l + (-l) % TILE
    # one row's outputs are allocated 1-D, not as views of (1, Lp) tensors
    lead = x.shape[:-1]
    q = x.new_empty(lead + (lp,), dtype=torch.int8)
    s = x.new_empty(lead + (lp // TILE,))
    if b and lp:
        _quantize(x.data_ptr(), q.data_ptr(), s.data_ptr(), b, l, lp, current_stream(dev))
        launches += 1
    return q, s


def dequantize_cuda(q: torch.Tensor, scales: torch.Tensor,
                    orig_len: int) -> torch.Tensor:
    """q (Lp,) int8, scales (Lp / 1024,) fp32, contiguous on one CUDA
    device -> (orig_len,) fp32, ``q[i] * scales[i // 1024]``."""
    global dequantize_launches
    if q.dim() != 1 or q.shape[0] % TILE:
        raise ValueError(f"q must be (Lp,) with Lp % {TILE} == 0 (got {tuple(q.shape)})")
    lp = q.shape[0]
    if not 0 <= orig_len <= lp:
        raise ValueError(f"orig_len must be within [0, {lp}] (got {orig_len})")
    dev = check_args(("q", q, torch.int8, None), ("scales", scales, torch.float32, (lp // TILE,)))
    out = scales.new_empty((orig_len,))
    if orig_len:
        _dequantize(q.data_ptr(), scales.data_ptr(), out.data_ptr(), orig_len,
                    current_stream(dev))
        dequantize_launches += 1
    return out
