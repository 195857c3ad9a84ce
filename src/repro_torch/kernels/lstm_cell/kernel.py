"""Launcher of the LSTM-cell kernel (``csrc/lstm_cell.cu``).

Replaces ``repro.kernels.lstm_cell.kernel.lstm_cell_pallas``, with a
leading lane axis: the fleet's lanes train different params in one launch.
``launches`` counts the launches made through :func:`lstm_cell_cuda`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_INT_MAX = 2 ** 31 - 1


def _lane_arg(name: str, t: torch.Tensor, shape, device) -> int:
    """Check one input (fp32 on ``device``, the given shape, each lane's
    block contiguous) and return its lane stride in elements."""
    if t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device} (got {t.device})")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be torch.float32 (got {t.dtype})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)} (got {tuple(t.shape)})")
    for dim in range(1, len(shape)):
        dense = int(torch.Size(shape[dim + 1:]).numel())
        if shape[dim] > 1 and t.stride(dim) != dense:
            raise ValueError(f"{name} must be contiguous within a lane")
    stride = t.stride(0) if shape[0] > 1 else 0
    if not 0 <= stride <= _INT_MAX or t.numel() > _INT_MAX:
        raise ValueError(f"{name} is too large for 32-bit offsets")
    return stride


def lstm_cell_cuda(x, h, c, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (L, B, F), h and c (L, B, H), wx (L, F, 4H), wh (L, H, 4H),
    b (L, 4H), fp32 on one CUDA device, each lane's block contiguous (the
    lane stride is free) -> (h', c'), each a contiguous (L, B, H).  Without
    the lane axis (x (B, F), b (4H,)) it is one lane."""
    global launches
    if x.dim() == 2:
        h_out, c_out = lstm_cell_cuda(x[None], h[None], c[None], wx[None],
                                      wh[None], b[None])
        return h_out[0], c_out[0]
    if x.dim() != 3 or h.dim() != 3:
        raise ValueError("x and h must be (L, B, F) and (L, B, H)")
    lanes, batch, f = x.shape
    hidden = h.shape[2]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor (got {dev})")
    if lanes > 65535:
        raise ValueError(f"at most 65535 lanes per launch (got {lanes})")
    strides = [_lane_arg("x", x, (lanes, batch, f), dev),
               _lane_arg("h", h, (lanes, batch, hidden), dev),
               _lane_arg("c", c, (lanes, batch, hidden), dev),
               _lane_arg("wx", wx, (lanes, f, 4 * hidden), dev),
               _lane_arg("wh", wh, (lanes, hidden, 4 * hidden), dev),
               _lane_arg("b", b, (lanes, 4 * hidden), dev)]
    h_out = torch.empty((lanes, batch, hidden), dtype=torch.float32, device=dev)
    c_out = torch.empty((lanes, batch, hidden), dtype=torch.float32, device=dev)
    if lanes * batch * hidden == 0:
        return h_out, c_out
    fn = _build.function("lstm_cell_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(),
             wh.data_ptr(), b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
             lanes, batch, f, hidden, *strides, stream)
    launches += 1
    if err != 0:
        raise RuntimeError(f"lstm_cell kernel launch failed with CUDA error {err}")
    return h_out, c_out
