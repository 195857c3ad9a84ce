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
from repro_torch.kernels.common import check_cuda_arg
from repro_torch.kernels.quantize.ref import TILE

launches = 0
dequantize_launches = 0

_QUANT_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_DEQUANT_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p]


def quantize_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L) or (L,) fp32, contiguous on a CUDA device -> (q int8
    (B, Lp) or (Lp,), scales fp32 (B, Lp / 1024) or (Lp / 1024,)), with
    Lp = L rounded up to 1024; the ragged tail quantizes as zeros."""
    global launches
    if x.dim() not in (1, 2):
        raise ValueError(f"x must be (L,) or (B, L) (got {tuple(x.shape)})")
    check_cuda_arg("x", x, torch.float32)
    rows = x[None] if x.dim() == 1 else x
    b, l = rows.shape
    if b > 65535:
        raise ValueError(f"at most 65535 rows per launch (got {b})")
    lp = l + (-l) % TILE
    q = torch.empty((b, lp), dtype=torch.int8, device=x.device)
    s = torch.empty((b, lp // TILE), dtype=torch.float32, device=x.device)
    if b and lp:
        fn = _build.function("quantize_launch", _QUANT_ARGTYPES)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), b, l, lp, stream)
        launches += 1
        if err != 0:
            raise RuntimeError(f"quantize kernel launch failed with CUDA error {err}")
    return (q[0], s[0]) if x.dim() == 1 else (q, s)


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
    check_cuda_arg("q", q, torch.int8)
    check_cuda_arg("scales", scales, torch.float32, (lp // TILE,), q.device)
    out = torch.empty((orig_len,), dtype=torch.float32, device=q.device)
    if orig_len:
        fn = _build.function("dequantize_launch", _DEQUANT_ARGTYPES)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), orig_len, stream)
        dequantize_launches += 1
        if err != 0:
            raise RuntimeError(f"dequantize kernel launch failed with CUDA error {err}")
    return out
