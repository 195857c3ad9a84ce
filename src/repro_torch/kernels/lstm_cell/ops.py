"""Public ops: the LSTM cell and the LSTM over a sequence, differentiable.

``lstm_cell`` and ``lstm_seq`` dispatch on the tensor's device: a CPU
tensor runs the plain twin, a CUDA tensor launches the hand-written kernel
or raises, unless the caller selected the twins
(``kernels.common.plain_twins``).  The TPU kernel has no VJP, so :class:`LSTMSeqFunction`
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

from repro_torch.kernels.common import costed, op_cost, use_twin
from repro_torch.kernels.lstm_cell.kernel import (lstm_cell_cuda, lstm_seq_backward_cuda,
                                                  lstm_seq_cuda)
from repro_torch.kernels.lstm_cell.ref import (lstm_cell_ref, lstm_seq_backward_ref,
                                               lstm_seq_ref)


def _seq_bytes_ops(lanes, b, f, h, t, save):
    g4 = 4 * h
    weights = f * g4 + h * g4 + g4
    states = 2 * (t + 1) * b * h if save else 2 * b * h
    gates = 2 * b * (f + h) * g4 + 2 * b * g4
    return g4, weights, states, gates


def lstm_seq_cost(lanes: int, b: int, f: int, h: int, t: int, save: bool = False) -> dict:
    """The forward over T steps of L lanes: x, the initial states and the
    weights read once, the final states (or, with ``save``, the T + 1
    saved states) written once; the gate products, the bias and the
    elementwise cell, whose 3 sigmoids and 2 tanh a unit and step are its
    transcendentals."""
    _, weights, states, gates = _seq_bytes_ops(lanes, b, f, h, t, save)
    return op_cost(flops=lanes * t * (gates + 10 * b * h),
                   bytes_accessed=4 * lanes * (t * b * f + 2 * b * h + weights + states),
                   transcendentals=lanes * t * 5 * b * h, launches=int(lanes * b * h > 0))


def lstm_seq_backward_cost(lanes: int, b: int, f: int, h: int, t: int) -> dict:
    """The backward kernel over the saved states: it reads x, the T + 1
    states, the weights and the final cotangents and writes dgates, dh0 and
    dc0; it recomputes the gate products (and their transcendentals) and
    forms dgates wh^T."""
    g4, weights, states, gates = _seq_bytes_ops(lanes, b, f, h, t, True)
    return op_cost(flops=lanes * t * (gates + 2 * b * g4 * h + 40 * b * h),
                   bytes_accessed=4 * lanes * (t * b * f + states + weights + 2 * b * h
                                               + t * b * g4 + 2 * b * h),
                   transcendentals=lanes * t * 5 * b * h, launches=int(lanes * b * h > 0))


def lstm_weight_grad_flops(lanes: int, b: int, f: int, h: int, t: int,
                           need_dx: bool = True) -> int:
    """The products :func:`lstm_seq_backward` forms from dgates beside the
    kernel, one batched product each over a lane's T * B rows: dwx, dwh
    and, with ``need_dx``, dx (2 flops a multiply-add, as
    ``torch.utils.flop_counter`` counts ``bmm``)."""
    rows, g4 = t * b, 4 * h
    return 2 * lanes * rows * g4 * (f + h + (f if need_dx else 0))


def _seq_cost(x_seq, h0, *_, save=False):
    lanes = x_seq.shape[0] if x_seq.dim() == 4 else 1
    t, b, f = x_seq.shape[-3:]
    return lstm_seq_cost(lanes, b, f, h0.shape[-1], t, save)


def _cell_cost(x, h, *_):
    lanes = x.shape[0] if x.dim() == 3 else 1
    b, f = x.shape[-2:]
    return lstm_seq_cost(lanes, b, f, h.shape[-1], 1)


def _backward_cost(x_seq, h_seq, *_, need_dx=True, twin=None):
    lanes = x_seq.shape[0] if x_seq.dim() == 4 else 1
    t, b, f = x_seq.shape[-3:]
    h = h_seq.shape[-1]
    cost = lstm_seq_backward_cost(lanes, b, f, h, t)
    # the weight-gradient products run in plain torch beside the kernel on
    # the card (inside the twin on the CPU): counted with the torch products
    cost["torch_matmul_flops"] = lstm_weight_grad_flops(lanes, b, f, h, t, need_dx)
    return cost


@costed("lstm_cell", _cell_cost)
def lstm_cell(x, h, c, wx, wh, b):
    """(h', c') of one timestep, with or without the lane axis; shapes as
    in ``ref.lstm_cell_ref``."""
    if use_twin(x):
        return lstm_cell_ref(x, h, c, wx, wh, b)
    return lstm_cell_cuda(x, h, c, wx, wh, b)


def _lanes(*ts):
    return [t[None] for t in ts]


@costed("lstm_cell", _seq_cost)
def lstm_seq(x_seq, h0, c0, wx, wh, b, save: bool = False):
    """The final states (h_T, c_T), or with ``save`` the states before and
    after every step (h_seq, c_seq), (L, T+1, B, H); with or without the
    lane axis."""
    if use_twin(x_seq):
        h_seq, c_seq = lstm_seq_ref(x_seq, h0, c0, wx, wh, b)
        return (h_seq, c_seq) if save else (h_seq[..., -1, :, :], c_seq[..., -1, :, :])
    if x_seq.dim() == 3:
        h, c = lstm_seq_cuda(*_lanes(x_seq, h0, c0, wx, wh, b), save=save)
        return h[0], c[0]
    return lstm_seq_cuda(x_seq, h0, c0, wx, wh, b, save=save)


@costed("lstm_cell_bwd", _backward_cost)
def lstm_seq_backward(x_seq, h_seq, c_seq, wx, wh, b, dh_last, dc_last, need_dx=True,
                      twin=None):
    """The gradient of :func:`lstm_seq` from its saved states:
    (dgates, dh0, dc0, dx_seq, dwx, dwh, db) as ``ref.lstm_seq_backward_ref``
    returns them.  On the card the kernel gives dgates, dh0 and dc0, and
    the weight gradients are one batched product each over the T * B rows
    of a lane; dx_seq is formed only with ``need_dx`` (else None).
    ``twin`` is the forward's selection (None: select here)."""
    if use_twin(x_seq) if twin is None else twin:
        return lstm_seq_backward_ref(x_seq, h_seq, c_seq, wx, wh, b, dh_last, dc_last)
    if x_seq.dim() == 3:
        out = _backward_lanes(*_lanes(x_seq, h_seq, c_seq, wx, wh, b, dh_last, dc_last),
                              need_dx=need_dx)
        return tuple(None if t is None else t[0] for t in out)
    return _backward_lanes(x_seq, h_seq, c_seq, wx, wh, b, dh_last, dc_last, need_dx)


def _backward_lanes(x_seq, h_seq, c_seq, wx, wh, b, dh_last, dc_last, need_dx):
    """The card's backward with the lane axis: the kernel, then the weight
    gradients as batched products."""
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
        # the backward keeps the forward's kernel selection: autograd runs a
        # CUDA backward on its own thread, where ``plain_twins()`` (a
        # context variable of the caller's thread) is not set
        ctx.twin = use_twin(x_seq)
        h_seq, c_seq = lstm_seq(x_seq, h0, c0, wx, wh, b, save=True)
        ctx.save_for_backward(x_seq, h_seq, c_seq, wx, wh, b)
        return h_seq[..., -1, :, :].clone(), c_seq[..., -1, :, :].clone()

    @staticmethod
    def backward(ctx, dh_last, dc_last):
        _, dh0, dc0, dx, dwx, dwh, db = lstm_seq_backward(
            *ctx.saved_tensors, dh_last, dc_last, need_dx=ctx.needs_input_grad[0],
            twin=ctx.twin)
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
