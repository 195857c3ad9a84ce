"""Launcher of the AES-128-CTR kernel (``csrc/aes_ctr.cu``).

Replaces ``repro.kernels.aes_ctr.kernel.aes_ctr_pallas``.  ``launches``
counts the launches made through :func:`aes_ctr_cuda`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda_arg

launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p]


def aes_ctr_cuda(payload: torch.Tensor, round_keys: torch.Tensor,
                 nonce: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """payload (n,) uint8, round_keys (11, 16) uint8, nonce (8,) uint8,
    tables (3, 256) uint8 (S-box, x2, x3), all contiguous on one CUDA
    device -> (n,) uint8 ciphertext (or plaintext: CTR is an involution)."""
    global launches
    if payload.dim() != 1:
        raise ValueError(f"payload must be 1-D (got {tuple(payload.shape)})")
    n = payload.shape[0]
    dev = payload.device
    check_cuda_arg("payload", payload, torch.uint8)
    check_cuda_arg("round_keys", round_keys, torch.uint8, (11, 16), dev)
    check_cuda_arg("nonce", nonce, torch.uint8, (8,), dev)
    check_cuda_arg("tables", tables, torch.uint8, (3, 256), dev)
    if n >= 2 ** 31:
        raise ValueError(f"payload of {n} bytes exceeds the 2 GiB limit")
    out = torch.empty_like(payload)
    if n == 0:
        return out
    fn = _build.function("aes_ctr_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(payload.data_ptr(), out.data_ptr(), n, tables.data_ptr(),
             round_keys.data_ptr(), nonce.data_ptr(), stream)
    launches += 1
    if err != 0:
        raise RuntimeError(f"aes_ctr kernel launch failed with CUDA error {err}")
    return out
