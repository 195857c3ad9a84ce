"""Launchers of the whole-sequence LSTM kernels (``csrc/lstm_cell.cu``).

:func:`lstm_seq_cuda` runs T steps of the cell in one launch and
:func:`lstm_seq_backward_cuda` walks them back in another.  The one-step
op :func:`lstm_cell_cuda`, which replaces
``repro.kernels.lstm_cell.kernel.lstm_cell_pallas``, is the forward at
T = 1.  Every input carries a leading lane axis (the fleet's lanes train
different params in one launch) and may have any lane stride.
``launches`` counts forward launches, ``bwd_launches`` backward ones.

:func:`plan` sizes a launch and refuses, with a ``ValueError``, a shape
whose weights do not fit in a block's shared memory; the launchers call it
before they look at the device, so the refusal shows on the CPU too.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda_arg

launches = 0
bwd_launches = 0

MAX_SHARED_BYTES = 232_448   # dynamic shared memory of one H100 block (227 KB)
ROWS = 4                     # batch rows a thread owns (kRows in the source)
THREADS = 256                # threads a block aims at: H x groups
MAX_HIDDEN = 1024            # one thread per column j: at most 1024 threads

_FWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_INT_MAX = 2 ** 31 - 1


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _shared_bytes(f: int, hidden: int, tile: int, backward: bool) -> int:
    """Dynamic shared memory of one block, as the source lays it out: the
    lane's [wx; wh] at a row stride of 4H + 1 floats, b, the h tile (two
    in the forward), and in the backward the (tile, 4H) dgates tile."""
    weights = _round4((f + hidden) * (4 * hidden + 1))
    h_tiles = (1 if backward else 2) * tile * _round4(hidden)
    dgates = tile * 4 * hidden if backward else 0
    return 4 * (weights + 4 * hidden + h_tiles + dgates)


def plan(batch: int, f: int, hidden: int, backward: bool = False) -> Tuple[int, int]:
    """(groups, shared bytes) of one launch: a block of ``hidden * groups``
    threads takes a tile of ``groups * ROWS`` batch rows.  Raises
    ``ValueError`` when that block's shared memory passes
    ``MAX_SHARED_BYTES``; there is no other path for such a shape."""
    kind = "backward" if backward else "forward"
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"the LSTM {kind} kernel takes 1 <= H <= {MAX_HIDDEN} (got H={hidden})")
    groups = max(1, min(THREADS // hidden, -(-batch // ROWS)))
    smem = _shared_bytes(f, hidden, groups * ROWS, backward)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"the LSTM {kind} kernel keeps a lane's weights in shared memory: F={f}, "
            f"H={hidden} needs {smem} B, over the {MAX_SHARED_BYTES} B (227 KB) a block "
            "of an H100 can have")
    return groups, smem


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


def _seq_shapes(x_seq, h, backward):
    """(lanes, steps, batch, f, hidden, groups, smem) of a launch, the plan
    checked before the device."""
    if x_seq.dim() != 4 or h.dim() != 3:
        raise ValueError("x_seq must be (L, T, B, F) and the states (L, B, H)")
    lanes, steps, batch, f = x_seq.shape
    hidden = h.shape[2]
    groups, smem = plan(batch, f, hidden, backward)
    if steps < 1:
        raise ValueError("the sequence needs at least one step")
    if x_seq.device.type != "cuda":
        raise ValueError(f"x_seq must be a CUDA tensor (got {x_seq.device})")
    if lanes > 65535:
        raise ValueError(f"at most 65535 lanes per launch (got {lanes})")
    return lanes, steps, batch, f, hidden, groups, smem


def _weight_strides(wx, wh, b, lanes, f, hidden, dev):
    return [_lane_arg("wx", wx, (lanes, f, 4 * hidden), dev),
            _lane_arg("wh", wh, (lanes, hidden, 4 * hidden), dev),
            _lane_arg("b", b, (lanes, 4 * hidden), dev)]


def lstm_seq_cuda(x_seq, h0, c0, wx, wh, b, save: bool = False):
    """x_seq (L, T, B, F), h0 and c0 (L, B, H), wx (L, F, 4H), wh (L, H, 4H),
    b (L, 4H), fp32 on one CUDA device, each lane's block contiguous (the
    lane stride is free) -> (h, c): the final states, each a contiguous
    (L, B, H), or with ``save`` the states before and after every step,
    each a contiguous (L, T+1, B, H) whose [:, 0] is h0, c0."""
    global launches
    lanes, steps, batch, f, hidden, groups, smem = _seq_shapes(x_seq, h0, False)
    dev = x_seq.device
    x_ls = _lane_arg("x_seq", x_seq, (lanes, steps, batch, f), dev)
    h_ls = _lane_arg("h0", h0, (lanes, batch, hidden), dev)
    c_ls = _lane_arg("c0", c0, (lanes, batch, hidden), dev)
    w_ls = _weight_strides(wx, wh, b, lanes, f, hidden, dev)
    shape = (lanes, steps + 1, batch, hidden) if save else (lanes, batch, hidden)
    h_out = torch.empty(shape, dtype=torch.float32, device=dev)
    c_out = torch.empty(shape, dtype=torch.float32, device=dev)
    if lanes * batch * hidden == 0:
        return h_out, c_out
    fn = _build.function("lstm_seq_fwd_launch", _FWD_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x_seq.data_ptr(), h0.data_ptr(), c0.data_ptr(), wx.data_ptr(), wh.data_ptr(),
             b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), lanes, steps, batch, f,
             hidden, groups, int(save), x_ls, h_ls, c_ls, *w_ls, smem, stream)
    launches += 1
    if err != 0:
        raise RuntimeError(f"lstm_seq forward kernel launch failed with CUDA error {err}")
    return h_out, c_out


def lstm_seq_backward_cuda(x_seq, h_seq, c_seq, wx, wh, b, dh_last, dc_last):
    """The backward of :func:`lstm_seq_cuda` from its saved states: x_seq,
    wx, wh, b as there; h_seq, c_seq (L, T+1, B, H) and the cotangents of
    the final states dh_last, dc_last (L, B, H), contiguous.  Returns
    (dgates (L, T, B, 4H), dh0, dc0 (L, B, H)), contiguous: the cotangents
    of each step's gate pre-activations and of the initial states."""
    global bwd_launches
    lanes, steps, batch, f, hidden, groups, smem = _seq_shapes(x_seq, dh_last, True)
    dev = x_seq.device
    x_ls = _lane_arg("x_seq", x_seq, (lanes, steps, batch, f), dev)
    for name, t, shape in (("h_seq", h_seq, (lanes, steps + 1, batch, hidden)),
                           ("c_seq", c_seq, (lanes, steps + 1, batch, hidden)),
                           ("dh_last", dh_last, (lanes, batch, hidden)),
                           ("dc_last", dc_last, (lanes, batch, hidden))):
        check_cuda_arg(name, t, torch.float32, shape, dev)
    w_ls = _weight_strides(wx, wh, b, lanes, f, hidden, dev)
    dgates = torch.empty((lanes, steps, batch, 4 * hidden), dtype=torch.float32, device=dev)
    dh0 = torch.empty((lanes, batch, hidden), dtype=torch.float32, device=dev)
    dc0 = torch.empty_like(dh0)
    if lanes * batch * hidden == 0:
        return dgates, dh0, dc0
    fn = _build.function("lstm_seq_bwd_launch", _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x_seq.data_ptr(), h_seq.data_ptr(), c_seq.data_ptr(), wx.data_ptr(),
             wh.data_ptr(), b.data_ptr(), dh_last.data_ptr(), dc_last.data_ptr(),
             dgates.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), lanes, steps, batch, f,
             hidden, groups, x_ls, *w_ls, smem, stream)
    bwd_launches += 1
    if err != 0:
        raise RuntimeError(f"lstm_seq backward kernel launch failed with CUDA error {err}")
    return dgates, dh0, dc0


def lstm_cell_cuda(x, h, c, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """One timestep: x (L, B, F), h and c (L, B, H), wx (L, F, 4H),
    wh (L, H, 4H), b (L, 4H) -> (h', c'), each a contiguous (L, B, H); the
    forward kernel at T = 1.  Without the lane axis (x (B, F), b (4H,)) it
    is one lane."""
    if x.dim() == 2:
        h_out, c_out = lstm_cell_cuda(x[None], h[None], c[None], wx[None],
                                      wh[None], b[None])
        return h_out[0], c_out[0]
    if x.dim() != 3:
        raise ValueError("x must be (L, B, F)")
    return lstm_seq_cuda(x[:, None], h, c, wx, wh, b)
