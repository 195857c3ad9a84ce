"""Launchers of the eq. 14 kernels (``csrc/fedavg.cu``).

``fedavg_batched_cuda`` replaces ``repro.kernels.fedavg.kernel.fedavg_pallas``
and ``fedavg_batched_pallas``: one CUDA kernel over an (R, N, L) buffer.
``fedavg_batched_q8_cuda`` replaces ``fedavg_batched_q8_pallas``: eq. 14
read straight from the int8 wire format, by the same kernel body with the
int8 loader, so it equals the dense kernel on the dequantized buffer bit for
bit.  ``launches`` counts the fp32 launches, ``q8_launches`` the int8 ones.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_args, current_stream
from repro_torch.kernels.quantize.ref import TILE

launches = 0
q8_launches = 0

F32 = torch.float32
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_Q8_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_fedavg = _build.CFunction("fedavg_launch", _ARGTYPES)
_fedavg_q8 = _build.CFunction("fedavg_q8_launch", _Q8_ARGTYPES)


def fedavg_batched_cuda(updates: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """updates (R, N, L) fp32, weights (R, N) fp32, both contiguous on
    one CUDA device -> (R, L) fp32 per-session weighted means."""
    global launches
    if updates.dim() != 3:
        raise ValueError(f"updates must be (R, N, L) (got {tuple(updates.shape)})")
    r, n, l = updates.shape
    dev = check_args(("updates", updates, F32, None), ("weights", weights, F32, (r, n)))
    out = updates.new_empty((r, l))
    if r and l:
        _fedavg(updates.data_ptr(), weights.data_ptr(), out.data_ptr(), r, n, l,
                current_stream(dev))
        launches += 1
    return out


def fedavg_batched_q8_cuda(q: torch.Tensor, scales: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """q (R, N, Lp) int8 with Lp % 1024 == 0, starting on a 4-byte
    boundary (the kernel reads 4 codes a load), scales (R, N, Lp / 1024)
    fp32, weights (R, N) fp32, all contiguous on one CUDA device -> (R, Lp)
    fp32 per-session weighted means of ``q * scale``."""
    global q8_launches
    if q.dim() != 3 or q.shape[-1] % TILE:
        raise ValueError(f"q must be (R, N, Lp) with Lp % {TILE} == 0 "
                         f"(got {tuple(q.shape)})")
    if q.data_ptr() % 4:
        raise ValueError("q must start on a 4-byte boundary "
                         f"(got an address {q.data_ptr() % 4} bytes past one)")
    r, n, lp = q.shape
    dev = check_args(("q", q, torch.int8, None), ("scales", scales, F32, (r, n, lp // TILE)),
                     ("weights", weights, F32, (r, n)))
    out = scales.new_empty((r, lp))
    if r and lp:
        _fedavg_q8(q.data_ptr(), scales.data_ptr(), weights.data_ptr(), out.data_ptr(),
                   r, n, lp, current_stream(dev))
        q8_launches += 1
    return out
