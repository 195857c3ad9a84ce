"""Plain PyTorch LSTM cell and its gradient: the spec of
``csrc/lstm_cell.cu`` and of a later backward kernel."""

from __future__ import annotations

import torch


def lstm_cell_ref(x, h, c, wx, wh, b):
    """x (B, F); h, c (B, H); wx (F, 4H); wh (H, 4H); b (4H,).  Gate layout
    [i | f | g | o] along 4H.  Returns (h', c')."""
    gates = x @ wx + h @ wh + b
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell_backward_ref(x, h, c, wx, wh, b, dh_new, dc_new):
    """Gradient of :func:`lstm_cell_ref` given the output cotangents,
    recomputing the gates from the inputs.  Returns
    (dx, dh, dc, dwx, dwh, db)."""
    gates = x @ wx + h @ wh + b
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
    return (dgates @ wx.t(), dgates @ wh.t(), dc_tot * sf,
            x.t() @ dgates, h.t() @ dgates, dgates.sum(dim=0))
