"""Recurrent blocks: RG-LRU (Griffin / RecurrentGemma) and xLSTM (port of
``repro.models.recurrent``).

RG-LRU [arXiv:2402.19427]:
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    a_t = exp(-c * softplus(lam) * sigmoid(r_t)),  c = 8
Full-sequence mode runs the linear first-order recurrence as a log-depth
(Hillis-Steele) scan over time, where the reference calls
``jax.lax.associative_scan``; both reorder the sums of a sequential scan, so
the port is held to the reference allclose.  Decode mode is one step
carrying ``h``.  On a ``model`` split (``tp``) each rank computes its
block of the W channels: its columns of ``wx``, ``wy``, ``conv_w`` and the
gates, its slice of ``conv_b`` and ``lam``; the gates read every channel
of the conv'd input (one all-gather), and its rows of ``wo`` give a
partial output summed over ``model``; a decode's state blocks hold its
channels.

xLSTM [arXiv:2405.04517]:
  * mLSTM: matrix memory C (dh x dh per head), exponential input gate,
    stabilized with a running max state m.
  * sLSTM: scalar memory with exponential gating and a recurrent kernel.
Both iterate over time step by step and carry O(1)-in-seq state for decode.
``ModelConfig.mlstm_chunk`` splits the mLSTM's time loop into chunks that a
backward recomputes (``torch.utils.checkpoint``); the forward is the same
for every chunk size.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.ctx import pvary_manual
from repro_torch.sharding.specs import P

_RG_LRU_C = 8.0
_F32 = torch.float32


# ---------------------------------------------------------------------------
# RG-LRU / Griffin recurrent block
# ---------------------------------------------------------------------------


def rglru_init(generator, cfg: ModelConfig, device=None) -> dict:
    W = rglru_width(cfg)
    dt = cfg.torch_dtype
    # lambda init so that a ~ U[0.9, 0.999]^c-root (Griffin appendix)
    u = torch.rand((W,), generator=generator, dtype=_F32) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / _RG_LRU_C))

    def dense(fan_in, fan_out, scale=1.0):
        return layers.dense_init(generator, fan_in, fan_out, dt, scale=scale, device=device)

    return {
        "wx": dense(cfg.d_model, W),                               # recurrent branch
        "wy": dense(cfg.d_model, W),                               # gate branch
        "conv_w": (torch.randn((cfg.conv_width, W), generator=generator, dtype=_F32)
                   * 0.02).to(device=device, dtype=dt),
        "conv_b": torch.zeros((W,), dtype=dt, device=device),
        "w_input_gate": dense(W, W, 0.5),
        "w_rec_gate": dense(W, W, 0.5),
        "lam": lam.to(device),
        "wo": dense(W, cfg.d_model),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B,S,W); w: (K,W)."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):  # K is 4: unrolled taps
        out = out + pad[:, k: k + x.shape[1], :] * w[k]
    return out + b


def _rglru_coeffs(params, x, x_all=None):
    """Gated decay a_t and normalized input b_t for the linear scan.  On a
    ``model`` split ``x`` holds this rank's channels and ``x_all`` every
    channel (the gates' input; ``x`` itself unsplit)."""
    x_all = x if x_all is None else x_all
    r = torch.sigmoid(x_all @ params["w_rec_gate"])
    i = torch.sigmoid(x_all @ params["w_input_gate"])
    log_a = -_RG_LRU_C * layers.softplus(params["lam"]) * r.to(_F32)
    a = torch.exp(log_a)
    # sqrt(1 - a^2) multiplier keeps the state norm bounded
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    b = mult * (i * x).to(_F32)
    return a, b


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, as a log-depth
    scan: after the pass at ``shift`` every (A, B) pair composes the
    ``2 * shift`` steps ending at it."""
    S = a.shape[1]
    shift = 1
    while shift < S:
        a_prev = F.pad(a[:, :-shift], (0, 0, shift, 0), value=1.0)
        b_prev = F.pad(b[:, :-shift], (0, 0, shift, 0))
        a, b = a_prev * a, b_prev * a + b
        shift *= 2
    return b


def rglru_width(cfg: ModelConfig) -> int:
    return cfg.rnn_width or cfg.d_model


def rglru_channels(params, tp):
    """``params`` with its 1-D leaves (``conv_b``, ``lam``) cut to the
    channels whose columns ``wx`` holds over ``tp`` (a replicated leaf that
    each rank uses in part: its gradient summed over ``model``)."""
    if tp is None:
        return params
    w = params["wx"].shape[-1]
    return dict(params, conv_b=layers._local_bias(params["conv_b"], w, tp),
                lam=layers._local_bias(params["lam"], w, tp))


def _all_channels(u, tp):
    """``u`` (..., W/n), this rank's channels, gathered over ``model`` (the
    gates read every channel; each rank uses the gathered ``u`` for its
    own, so its gradient is summed back)."""
    if tp is None:
        return u
    return coll.gather(u, tp.mesh, P(*([None] * (u.dim() - 1)), "model"), summed=("model",))


def rglru_input(params, x):
    """The gate branch and the conv'd recurrent branch (B, S, W) of the
    channels whose columns ``wx`` and ``wy`` hold."""
    gate = F.gelu(x @ params["wy"], approximate="tanh")
    u = _causal_conv(x @ params["wx"], params["conv_w"], params["conv_b"])
    return gate, u


def rglru_mix(params, gate, u, u_all):
    """The scanned and gated output (B, S, W) of the channels of ``u``,
    their gates read from ``u_all``."""
    a, b = _rglru_coeffs(params, u, u_all)
    return linear_scan(a, b).to(gate.dtype) * gate


def _rglru_out(h, wo, cfg: ModelConfig, tp):
    """``h @ wo``; over ``tp`` the rows of the whole ``wo`` for this rank's
    channels, the partial outputs summed over ``model``."""
    if tp is None:
        return h @ wo
    w = h.shape[-1]
    return layers.project_out(h, wo[tp.index * w:(tp.index + 1) * w], cfg.d_model, tp)


def rglru_apply(params, x, cfg: ModelConfig, tp=None):
    """Full-sequence Griffin block. x: (B,S,D) -> (B,S,D).  Channel-parallel
    over ``tp`` when given: ``wx``, ``wy``, ``conv_w`` and the gates hold
    this rank's channels' columns, ``wo`` is whole."""
    if tp is not None:
        x = coll.sum_grad(x, tp.mesh, "model")
    p = rglru_channels(params, tp)
    gate, u = rglru_input(p, x)
    return _rglru_out(rglru_mix(p, gate, u, _all_channels(u, tp)), params["wo"], cfg, tp)


def rglru_init_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    W = rglru_width(cfg)
    return {
        "h": torch.zeros((batch, W), dtype=_F32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, W), dtype=cfg.torch_dtype,
                            device=device),
    }


def rglru_decode(params, x, state, cfg: ModelConfig, tp=None):
    """One-token Griffin step. x: (B,1,D).  Over ``tp`` on this rank's
    channels, ``state`` its blocks (``h`` (B, W/n), ``conv`` (B, K-1, W/n))."""
    p = rglru_channels(params, tp)
    gate = F.gelu(x @ p["wy"], approximate="tanh")                 # (B,1,W)
    u = (x @ p["wx"])[:, 0, :]                                     # (B,W)
    hist = torch.cat([state["conv"], u[:, None, :]], dim=1)        # (B,K,W)
    u_conv = (torch.einsum("bkw,kw->bw", hist, p["conv_w"]) + p["conv_b"])[:, None, :]
    a, b = _rglru_coeffs(p, u_conv, _all_channels(u_conv, tp))
    h = a[:, 0] * state["h"] + b[:, 0]
    out = _rglru_out(h[:, None, :].to(x.dtype) * gate, params["wo"], cfg, tp)
    return out, {"h": h, "conv": hist[:, 1:, :]}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM
# ---------------------------------------------------------------------------


def _xlstm_dims(cfg: ModelConfig):
    d_inner = int(cfg.d_model * cfg.mlstm_proj_factor)
    H = cfg.num_heads
    dh = d_inner // H
    return d_inner, H, dh


def mlstm_init(generator, cfg: ModelConfig, device=None) -> dict:
    d_inner, H, dh = _xlstm_dims(cfg)
    dt = cfg.torch_dtype

    def dense(fan_in, fan_out):
        return layers.dense_init(generator, fan_in, fan_out, dt, device=device)

    return {
        "w_up": dense(cfg.d_model, 2 * d_inner),
        "wq": dense(d_inner, d_inner),
        "wk": dense(d_inner, d_inner),
        "wv": dense(d_inner, d_inner),
        "w_if": dense(d_inner, 2 * H),
        "b_if": torch.cat([torch.zeros((H,)), torch.ones((H,)) * 3.0]).to(device=device,
                                                                            dtype=dt),
        "norm": layers.rmsnorm_init(d_inner, dt, device),
        "w_down": dense(d_inner, cfg.d_model),
    }


def _mlstm_step(carry, inp):
    """Stabilized mLSTM recurrence, one timestep.

    carry: C (B,H,dh,dh), n (B,H,dh), m (B,H)
    inp: q,k,v (B,H,dh), i_t, f_t (B,H) pre-activations
    """
    C, n, m = carry
    q, k, v, it, ft = inp
    log_f = -layers.softplus(-ft)                                  # log sigmoid(f)
    m_new = torch.maximum(log_f + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(log_f + m - m_new)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (v[..., :, None] * k[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * k
    num = torch.einsum("bhvk,bhk->bhv", C, q)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), torch.exp(-m_new))
    h = num / den[..., None]
    return (C, n, m_new), h


def _mlstm_steps(carry, xs):
    """The recurrence over the steps of ``xs`` (each (S, B, H, ...)):
    the last carry, the stacked outputs (S, B, H, dh)."""
    hs = []
    for t in range(xs[0].shape[0]):
        carry, h = _mlstm_step(carry, tuple(a[t] for a in xs))
        hs.append(h)
    return carry, torch.stack(hs)


def _mlstm_inputs(params, u, B, S, cfg: ModelConfig):
    d_inner, H, dh = _xlstm_dims(cfg)
    q = (u @ params["wq"]).reshape(B, S, H, dh).to(_F32) / math.sqrt(dh)
    k = (u @ params["wk"]).reshape(B, S, H, dh).to(_F32)
    v = (u @ params["wv"]).reshape(B, S, H, dh).to(_F32)
    gif = (u @ params["w_if"] + params["b_if"]).to(_F32)
    it, ft = torch.chunk(gif.reshape(B, S, 2 * H), 2, dim=-1)     # (B,S,H)
    return q, k, v, it, ft


def mlstm_apply(params, x, cfg: ModelConfig):
    """x: (B,S,D) -> (B,S,D). Sequential scan over time (train/prefill)."""
    B, S, D = x.shape
    d_inner, H, dh = _xlstm_dims(cfg)
    up = x @ params["w_up"]
    u, z = torch.chunk(up, 2, dim=-1)                              # (B,S,d_inner)
    q, k, v, it, ft = _mlstm_inputs(params, u, B, S, cfg)
    st = mlstm_init_state(cfg, B, x.device)
    carry = pvary_manual((st["C"], st["n"], st["m"]))
    xs = tuple(torch.movedim(a, 1, 0) for a in (q, k, v, it, ft))
    chunk = cfg.mlstm_chunk
    if chunk and S % chunk == 0 and S > chunk and torch.is_grad_enabled():
        # chunked remat: the (B,H,dh,dh) carry is kept only at chunk
        # boundaries; the backward recomputes within each chunk
        outs = []
        for c0 in range(0, S, chunk):
            carry, hs_c = checkpoint(_mlstm_steps, carry, tuple(a[c0:c0 + chunk] for a in xs),
                                     use_reentrant=False)
            outs.append(hs_c)
        hs = torch.cat(outs)
    else:
        _, hs = _mlstm_steps(carry, xs)
    h = torch.movedim(hs, 0, 1).reshape(B, S, d_inner).to(x.dtype)
    h = layers.rmsnorm_apply(params["norm"], h, cfg.norm_eps)
    h = h * F.silu(z)
    return h @ params["w_down"]


def mlstm_init_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    _, H, dh = _xlstm_dims(cfg)
    return {
        "C": torch.zeros((batch, H, dh, dh), dtype=_F32, device=device),
        "n": torch.zeros((batch, H, dh), dtype=_F32, device=device),
        "m": torch.full((batch, H), -1e30, dtype=_F32, device=device),
    }


def mlstm_decode(params, x, state, cfg: ModelConfig):
    B = x.shape[0]
    d_inner, H, dh = _xlstm_dims(cfg)
    up = x[:, 0, :] @ params["w_up"]
    u, z = torch.chunk(up, 2, dim=-1)
    q, k, v, it, ft = (a[:, 0] for a in _mlstm_inputs(params, u[:, None], B, 1, cfg))
    (C, n, m), h = _mlstm_step((state["C"], state["n"], state["m"]), (q, k, v, it, ft))
    h = h.reshape(B, d_inner).to(x.dtype)
    h = layers.rmsnorm_apply(params["norm"], h, cfg.norm_eps)
    h = h * F.silu(z)
    return (h @ params["w_down"])[:, None, :], {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# xLSTM: sLSTM
# ---------------------------------------------------------------------------


def slstm_init(generator, cfg: ModelConfig, device=None) -> dict:
    d_inner, H, dh = _xlstm_dims(cfg)
    dt = cfg.torch_dtype

    def dense(fan_in, fan_out):
        return layers.dense_init(generator, fan_in, fan_out, dt, device=device)

    return {
        "w_up": dense(cfg.d_model, d_inner),
        # input projections for z, i, f, o gates
        "w_gates": dense(d_inner, 4 * d_inner),
        # block-diagonal recurrent kernel: per head (dh x 4*dh)
        "r_gates": (torch.randn((H, dh, 4 * dh), generator=generator, dtype=_F32)
                    / math.sqrt(dh)).to(device=device, dtype=dt),
        "b_gates": torch.zeros((4 * d_inner,), dtype=dt, device=device),
        "norm": layers.rmsnorm_init(d_inner, dt, device),
        "w_down": dense(d_inner, cfg.d_model),
    }


def _slstm_step(params, carry, u_t, cfg: ModelConfig):
    """carry: c, n, m, h (B, d_inner) fp32; u_t: (B, d_inner)."""
    d_inner, H, dh = _xlstm_dims(cfg)
    c, n, m, h = carry
    B = u_t.shape[0]
    rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, dh), params["r_gates"].to(_F32))
    gates = (u_t @ params["w_gates"] + params["b_gates"]).to(_F32)
    gates = gates.reshape(B, H, 4 * dh) + rec
    z, i, f, o = torch.chunk(gates.reshape(B, 4 * d_inner), 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    log_f = -layers.softplus(-f)
    m_new = torch.maximum(log_f + m, i)
    i_p = torch.exp(i - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    h_new = o * c / torch.clamp_min(n, 1.0)
    return (c, n, m_new, h_new), h_new


def slstm_apply(params, x, cfg: ModelConfig):
    B, S, D = x.shape
    u = (x @ params["w_up"]).to(_F32)
    st = slstm_init_state(cfg, B, x.device)
    carry = pvary_manual((st["c"], st["n"], st["m"], st["h"]))
    hs = []
    for t in range(S):
        carry, h_t = _slstm_step(params, carry, u[:, t], cfg)
        hs.append(h_t)
    h = torch.stack(hs, dim=1).to(x.dtype)
    h = layers.rmsnorm_apply(params["norm"], h, cfg.norm_eps)
    return h @ params["w_down"]


def slstm_init_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    d_inner, _, _ = _xlstm_dims(cfg)
    return {
        "c": torch.zeros((batch, d_inner), dtype=_F32, device=device),
        "n": torch.zeros((batch, d_inner), dtype=_F32, device=device),
        "m": torch.full((batch, d_inner), -1e30, dtype=_F32, device=device),
        "h": torch.zeros((batch, d_inner), dtype=_F32, device=device),
    }


def slstm_decode(params, x, state, cfg: ModelConfig):
    u = (x[:, 0, :] @ params["w_up"]).to(_F32)
    carry = (state["c"], state["n"], state["m"], state["h"])
    (c, n, m, h), h_out = _slstm_step(params, carry, u, cfg)
    y = layers.rmsnorm_apply(params["norm"], h_out.to(x.dtype), cfg.norm_eps)
    return (y @ params["w_down"])[:, None, :], {"c": c, "n": n, "m": m, "h": h}
