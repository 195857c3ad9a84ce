"""Public op: the LSTM cell, differentiable.

``lstm_cell`` dispatches the forward pass: a CPU tensor runs the plain
twin, a CUDA tensor launches the hand-written kernel or raises.  The TPU
kernel has no VJP, so :class:`LSTMCellFunction` supplies one: its forward
goes through ``lstm_cell`` and its backward is plain PyTorch
(``ref.lstm_cell_backward_ref``) that recomputes the gates from the saved
inputs.  The classifier always calls the Function, so the CPU tests
exercise the same backward the card runs.  Inputs may carry a leading
lane axis (x (L, B, F), b (L, 4H)); the fleet trains its lanes that way and
the loop engine is the case L = 1.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import is_cpu
from repro_torch.kernels.lstm_cell.kernel import lstm_cell_cuda
from repro_torch.kernels.lstm_cell.ref import lstm_cell_backward_ref, lstm_cell_ref


def lstm_cell(x, h, c, wx, wh, b):
    """(h', c') of one timestep, with or without the lane axis; shapes as
    in ``ref.lstm_cell_ref``."""
    if is_cpu(x):
        return lstm_cell_ref(x, h, c, wx, wh, b)
    return lstm_cell_cuda(x, h, c, wx, wh, b)


class LSTMCellFunction(torch.autograd.Function):
    """The cell as an autograd node: kernel forward, recomputing backward."""

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        ctx.save_for_backward(x, h, c, wx, wh, b)
        return lstm_cell(x, h, c, wx, wh, b)

    @staticmethod
    def backward(ctx, dh_new, dc_new):
        return lstm_cell_backward_ref(*ctx.saved_tensors, dh_new, dc_new)


def lstm_cell_autograd(x, h, c, wx, wh, b):
    """The differentiable cell: (h', c')."""
    return LSTMCellFunction.apply(x, h, c, wx, wh, b)
