"""Launcher of the LSTM-cell kernel (``csrc/lstm_cell.cu``).

Replaces ``repro.kernels.lstm_cell.kernel.lstm_cell_pallas``.
``launches`` counts the launches made through :func:`lstm_cell_cuda`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda_arg

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def lstm_cell_cuda(x, h, c, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, F), h and c (B, H), wx (F, 4H), wh (H, 4H), b (4H,), all fp32
    and contiguous on one CUDA device -> (h', c'), each (B, H)."""
    global launches
    if x.dim() != 2 or h.dim() != 2:
        raise ValueError("x and h must be 2-D")
    batch, f = x.shape
    hidden = h.shape[1]
    dev = x.device
    check_cuda_arg("x", x, torch.float32)
    check_cuda_arg("h", h, torch.float32, (batch, hidden), dev)
    check_cuda_arg("c", c, torch.float32, (batch, hidden), dev)
    check_cuda_arg("wx", wx, torch.float32, (f, 4 * hidden), dev)
    check_cuda_arg("wh", wh, torch.float32, (hidden, 4 * hidden), dev)
    check_cuda_arg("b", b, torch.float32, (4 * hidden,), dev)
    h_out = torch.empty((batch, hidden), dtype=torch.float32, device=dev)
    c_out = torch.empty((batch, hidden), dtype=torch.float32, device=dev)
    if batch * hidden == 0:
        return h_out, c_out
    fn = _build.function("lstm_cell_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(),
             wh.data_ptr(), b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
             batch, f, hidden, stream)
    launches += 1
    if err != 0:
        raise RuntimeError(f"lstm_cell kernel launch failed with CUDA error {err}")
    return h_out, c_out
