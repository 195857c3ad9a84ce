"""Launchers of the eq. 14 kernels (``csrc/fedavg.cu``).

``fedavg_batched_cuda`` replaces ``repro.kernels.fedavg.kernel.fedavg_pallas``
and ``fedavg_batched_pallas``: one CUDA kernel over an (R, N, L) buffer.
``fedavg_batched_q8_cuda`` replaces ``fedavg_batched_q8_pallas``: eq. 14
read straight from the int8 wire format.  ``launches`` counts the fp32
launches, ``q8_launches`` the int8 ones.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda_arg
from repro_torch.kernels.quantize.ref import TILE

launches = 0
q8_launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_Q8_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def fedavg_batched_cuda(updates: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """updates (R, N, L) fp32, weights (R, N) fp32, both contiguous on
    one CUDA device -> (R, L) fp32 per-session weighted means."""
    global launches
    if updates.dim() != 3:
        raise ValueError(f"updates must be (R, N, L) (got {tuple(updates.shape)})")
    r, n, l = updates.shape
    check_cuda_arg("updates", updates, torch.float32)
    check_cuda_arg("weights", weights, torch.float32, (r, n), updates.device)
    if r > 65535:
        raise ValueError(f"at most 65535 sessions per launch (got {r})")
    out = torch.empty((r, l), dtype=torch.float32, device=updates.device)
    if r == 0 or l == 0:
        return out
    fn = _build.function("fedavg_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(updates.device).cuda_stream
    err = fn(updates.data_ptr(), weights.data_ptr(), out.data_ptr(),
             r, n, l, stream)
    launches += 1
    if err != 0:
        raise RuntimeError(f"fedavg kernel launch failed with CUDA error {err}")
    return out


def fedavg_batched_q8_cuda(q: torch.Tensor, scales: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """q (R, N, Lp) int8 with Lp % 1024 == 0, scales (R, N, Lp / 1024)
    fp32, weights (R, N) fp32, all contiguous on one CUDA device -> (R, Lp)
    fp32 per-session weighted means of ``q * scale``."""
    global q8_launches
    if q.dim() != 3 or q.shape[-1] % TILE:
        raise ValueError(f"q must be (R, N, Lp) with Lp % {TILE} == 0 "
                         f"(got {tuple(q.shape)})")
    r, n, lp = q.shape
    check_cuda_arg("q", q, torch.int8)
    check_cuda_arg("scales", scales, torch.float32, (r, n, lp // TILE), q.device)
    check_cuda_arg("weights", weights, torch.float32, (r, n), q.device)
    if r > 65535:
        raise ValueError(f"at most 65535 sessions per launch (got {r})")
    out = torch.empty((r, lp), dtype=torch.float32, device=q.device)
    if r == 0 or lp == 0:
        return out
    fn = _build.function("fedavg_q8_launch", _Q8_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), scales.data_ptr(), weights.data_ptr(), out.data_ptr(),
             r, n, lp, stream)
    q8_launches += 1
    if err != 0:
        raise RuntimeError(f"fedavg_q8 kernel launch failed with CUDA error {err}")
    return out
