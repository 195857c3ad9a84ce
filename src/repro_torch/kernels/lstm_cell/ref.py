"""Plain PyTorch LSTM cell, its sequence and their gradients: the spec of
the forward and backward kernels of ``csrc/lstm_cell.cu``.

Every tensor may carry a leading lane axis (the fleet trains L lanes with
different params at once): x (L, B, F), h and c (L, B, H), wx (L, F, 4H),
wh (L, H, 4H), b (L, 4H), and a sequence x_seq (L, T, B, F).  Without it,
x is (B, F), x_seq (T, B, F) and b is (4H,).
"""

from __future__ import annotations

import torch


def lstm_cell_ref(x, h, c, wx, wh, b):
    """One timestep.  Gate layout [i | f | g | o] along 4H.  Returns
    (h', c')."""
    gates = x @ wx + h @ wh + b[..., None, :]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def _cell_dgates(x, h, c, wx, wh, b, dh_new, dc_new):
    """The cotangents of one step's gate pre-activations, (B, 4H), and of
    its input c, recomputing the gates from the inputs."""
    gates = x @ wx + h @ wh + b[..., None, :]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    si, sf, tg, so = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    c_new = sf * c + si * tg
    tc = torch.tanh(c_new)
    dc_tot = dc_new + dh_new * so * (1.0 - tc * tc)
    d_i = dc_tot * tg * si * (1.0 - si)
    d_f = dc_tot * c * sf * (1.0 - sf)
    d_g = dc_tot * si * (1.0 - tg * tg)
    d_o = dh_new * tc * so * (1.0 - so)
    return torch.cat([d_i, d_f, d_g, d_o], dim=-1), dc_tot * sf


def lstm_cell_backward_ref(x, h, c, wx, wh, b, dh_new, dc_new):
    """Gradient of :func:`lstm_cell_ref` given the output cotangents,
    recomputing the gates from the inputs.  Returns
    (dx, dh, dc, dwx, dwh, db); the bias gradient sums over the batch
    axis only, so each lane keeps its own."""
    dgates, dc = _cell_dgates(x, h, c, wx, wh, b, dh_new, dc_new)
    return (dgates @ wx.transpose(-1, -2), dgates @ wh.transpose(-1, -2), dc,
            x.transpose(-1, -2) @ dgates, h.transpose(-1, -2) @ dgates,
            dgates.sum(dim=-2))


def lstm_seq_ref(x_seq, h0, c0, wx, wh, b):
    """T steps of :func:`lstm_cell_ref` from (h0, c0).  Returns
    (h_seq, c_seq), each (L, T+1, B, H): the states before and after every
    step, so h_seq[:, 0] is h0 and h_seq[:, T] the final state."""
    hs, cs = [h0], [c0]
    for t in range(x_seq.shape[-3]):
        h, c = lstm_cell_ref(x_seq[..., t, :, :], hs[-1], cs[-1], wx, wh, b)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, dim=-3), torch.stack(cs, dim=-3)


def lstm_seq_backward_ref(x_seq, h_seq, c_seq, wx, wh, b, dh_last, dc_last):
    """Gradient of :func:`lstm_seq_ref` from its saved states, given the
    cotangents of the final states: :func:`lstm_cell_backward_ref` over
    t = T-1 ... 0.  Returns (dgates, dh0, dc0, dx_seq, dwx, dwh, db):
    dgates (L, T, B, 4H), the cotangents of every step's gate
    pre-activations, then the gradients of the six inputs.  The weight
    gradients are each step's, summed in reverse t, the order in which
    autograd accumulates them through T cell nodes."""
    dh, dc = dh_last, dc_last
    dgates, dxs = [], []
    dwx = dwh = db = None
    for t in reversed(range(x_seq.shape[-3])):
        x, h = x_seq[..., t, :, :], h_seq[..., t, :, :]
        dg, dc = _cell_dgates(x, h, c_seq[..., t, :, :], wx, wh, b, dh, dc)
        dxs.append(dg @ wx.transpose(-1, -2))
        dh = dg @ wh.transpose(-1, -2)
        step = (x.transpose(-1, -2) @ dg, h.transpose(-1, -2) @ dg, dg.sum(dim=-2))
        dwx, dwh, db = step if dwx is None else (dwx + step[0], dwh + step[1], db + step[2])
        dgates.append(dg)
    return (torch.stack(dgates[::-1], dim=-3), dh, dc, torch.stack(dxs[::-1], dim=-3),
            dwx, dwh, db)
