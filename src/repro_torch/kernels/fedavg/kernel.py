"""Launcher of the eq. 14 kernel (``csrc/fedavg.cu``).

Replaces ``repro.kernels.fedavg.kernel.fedavg_pallas`` and
``fedavg_batched_pallas``: one CUDA kernel over an (R, N, L) buffer.
``launches`` counts the launches made through :func:`fedavg_batched_cuda`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda_arg

launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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
