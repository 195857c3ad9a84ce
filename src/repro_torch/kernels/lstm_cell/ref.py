"""Plain PyTorch LSTM cell and its gradient: the spec of
``csrc/lstm_cell.cu`` and of a later backward kernel.

Every tensor may carry a leading lane axis (the fleet trains L lanes with
different params at once): x (L, B, F), h and c (L, B, H), wx (L, F, 4H),
wh (L, H, 4H), b (L, 4H).  Without it, x is (B, F) and b is (4H,).
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


def lstm_cell_backward_ref(x, h, c, wx, wh, b, dh_new, dc_new):
    """Gradient of :func:`lstm_cell_ref` given the output cotangents,
    recomputing the gates from the inputs.  Returns
    (dx, dh, dc, dwx, dwh, db); the bias gradient sums over the batch
    axis only, so each lane keeps its own."""
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
    dgates = torch.cat([d_i, d_f, d_g, d_o], dim=-1)
    return (dgates @ wx.transpose(-1, -2), dgates @ wh.transpose(-1, -2), dc_tot * sf,
            x.transpose(-1, -2) @ dgates, h.transpose(-1, -2) @ dgates,
            dgates.sum(dim=-2))
