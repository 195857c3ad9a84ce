"""Public ops: the LSTM cell and the LSTM over a sequence, differentiable.

``lstm_cell`` and ``lstm_seq`` dispatch on the tensor's device: a CPU
tensor runs the plain twin, a CUDA tensor launches the hand-written kernel
or raises.  The TPU kernel has no VJP, so :class:`LSTMSeqFunction`
supplies one: its forward runs the sequence kernel and saves every step's
states, its backward runs the backward kernel (``ref.lstm_seq_backward_ref``
on the CPU) and forms the weight gradients from the gate cotangents.  The
classifier calls the Function once per forward pass, so the CPU tests
exercise the same path the card runs.  Inputs may carry a leading lane axis
(x_seq (L, T, B, F), b (L, 4H)); the fleet trains its lanes that way and
the loop engine is the case L = 1.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import is_cpu
from repro_torch.kernels.lstm_cell.kernel import (lstm_cell_cuda, lstm_seq_backward_cuda,
                                                  lstm_seq_cuda)
from repro_torch.kernels.lstm_cell.ref import (lstm_cell_ref, lstm_seq_backward_ref,
                                               lstm_seq_ref)


def lstm_cell(x, h, c, wx, wh, b):
    """(h', c') of one timestep, with or without the lane axis; shapes as
    in ``ref.lstm_cell_ref``."""
    if is_cpu(x):
        return lstm_cell_ref(x, h, c, wx, wh, b)
    return lstm_cell_cuda(x, h, c, wx, wh, b)


def _lanes(*ts):
    return [t[None] for t in ts]


def lstm_seq(x_seq, h0, c0, wx, wh, b, save: bool = False):
    """The final states (h_T, c_T), or with ``save`` the states before and
    after every step (h_seq, c_seq), (L, T+1, B, H); with or without the
    lane axis."""
    if is_cpu(x_seq):
        h_seq, c_seq = lstm_seq_ref(x_seq, h0, c0, wx, wh, b)
        return (h_seq, c_seq) if save else (h_seq[..., -1, :, :], c_seq[..., -1, :, :])
    if x_seq.dim() == 3:
        h, c = lstm_seq_cuda(*_lanes(x_seq, h0, c0, wx, wh, b), save=save)
        return h[0], c[0]
    return lstm_seq_cuda(x_seq, h0, c0, wx, wh, b, save=save)


def lstm_seq_backward(x_seq, h_seq, c_seq, wx, wh, b, dh_last, dc_last, need_dx=True):
    """The gradient of :func:`lstm_seq` from its saved states:
    (dgates, dh0, dc0, dx_seq, dwx, dwh, db) as ``ref.lstm_seq_backward_ref``
    returns them.  On the card the kernel gives dgates, dh0 and dc0, and
    the weight gradients are one batched product each over the T * B rows
    of a lane; dx_seq is formed only with ``need_dx`` (else None)."""
    if is_cpu(x_seq):
        return lstm_seq_backward_ref(x_seq, h_seq, c_seq, wx, wh, b, dh_last, dc_last)
    if x_seq.dim() == 3:
        out = lstm_seq_backward(*_lanes(x_seq, h_seq, c_seq, wx, wh, b, dh_last, dc_last),
                                need_dx=need_dx)
        return tuple(None if t is None else t[0] for t in out)
    dgates, dh0, dc0 = lstm_seq_backward_cuda(x_seq, h_seq, c_seq, wx, wh, b,
                                              dh_last.contiguous(), dc_last.contiguous())
    lanes, steps, batch, f = x_seq.shape
    rows = dgates.view(lanes, steps * batch, -1)
    hidden = h_seq.shape[-1]
    dwx = torch.bmm(x_seq.reshape(lanes, steps * batch, f).transpose(1, 2), rows)
    dwh = torch.bmm(h_seq[:, :steps].reshape(lanes, steps * batch, hidden).transpose(1, 2),
                    rows)
    db = dgates.sum(dim=(1, 2))
    dx = (torch.bmm(rows, wx.transpose(1, 2)).view(lanes, steps, batch, f)
          if need_dx else None)
    return dgates, dh0, dc0, dx, dwx, dwh, db


class LSTMSeqFunction(torch.autograd.Function):
    """The sequence as an autograd node: the forward kernel saving every
    step's states, the backward kernel walking them back."""

    @staticmethod
    def forward(ctx, x_seq, h0, c0, wx, wh, b):
        h_seq, c_seq = lstm_seq(x_seq, h0, c0, wx, wh, b, save=True)
        ctx.save_for_backward(x_seq, h_seq, c_seq, wx, wh, b)
        return h_seq[..., -1, :, :].clone(), c_seq[..., -1, :, :].clone()

    @staticmethod
    def backward(ctx, dh_last, dc_last):
        _, dh0, dc0, dx, dwx, dwh, db = lstm_seq_backward(
            *ctx.saved_tensors, dh_last, dc_last, need_dx=ctx.needs_input_grad[0])
        return dx, dh0, dc0, dwx, dwh, db


def lstm_seq_autograd(x_seq, h0, c0, wx, wh, b):
    """The differentiable sequence: (h_T, c_T).  Where no gradient is
    wanted (grad mode off, as in scoring, or no input requiring one) it
    runs the forward alone and saves no states."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_seq, h0, c0, wx, wh, b)):
        return LSTMSeqFunction.apply(x_seq, h0, c0, wx, wh, b)
    return lstm_seq(x_seq, h0, c0, wx, wh, b)


def lstm_cell_autograd(x, h, c, wx, wh, b):
    """The differentiable cell, (h', c'): the sequence Function at T = 1."""
    return LSTMSeqFunction.apply(x.unsqueeze(-3), h, c, wx, wh, b)
