"""Mixture-of-experts layer (port of ``repro.models.moe``, its one-device
branch).

Two dispatch schedules, selected by ``MoEConfig.dispatch``:

* ``"sort"`` — sort-based scatter dispatch: top-k assignments are
  flattened choice-major, stably sorted by expert id, capacity is enforced
  by position-within-expert, and tokens are scattered into a per-expert
  buffer with one gather/scatter pair.  Memory is O(T*k*D), linear in
  tokens.
* ``"einsum"`` (the config's default) — the GShard one-hot dispatch, kept
  as the cross-validation oracle of the sort path; both enforce the same
  token-order-within-expert capacity-drop semantics.

Both keep the reference's capacity ``max(1, int(T*k*1.25/E))``, its
choice-major drop order and its Switch load-balance auxiliary loss.
``"ep"`` (the expert-parallel schedule) needs a mesh; without one it falls
back to ``"sort"``, as in the reference.  The mesh schedules (the
expert-parallel one, the token-local wrap and ``disable_token_local``) come
with the port's mesh tooling.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

CAPACITY_FACTOR = 1.25


def moe_init(generator, cfg: ModelConfig, device=None) -> dict:
    m = cfg.moe
    d_ff = m.d_ff_expert or cfg.d_ff
    dt = cfg.torch_dtype
    E = m.num_experts

    def experts(fan_in, fan_out):
        w = torch.randn((E, fan_in, fan_out), generator=generator, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(device=device, dtype=dt)

    p = {
        "router": layers.dense_init(generator, cfg.d_model, E, torch.float32, device=device),
        "wg": experts(cfg.d_model, d_ff),
        "wu": experts(cfg.d_model, d_ff),
        "wd": experts(d_ff, cfg.d_model),
    }
    if m.num_shared_experts > 0:
        p["shared"] = layers.mlp_init(generator, cfg, d_ff=d_ff * m.num_shared_experts,
                                      device=device)
    return p


def _expert_ffn(params, expert_in):
    """expert_in: (E, C, D) -> (E, C, D) batched SwiGLU."""
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, params["wg"]))
    h = h * torch.einsum("ecd,edf->ecf", expert_in, params["wu"])
    return torch.einsum("ecf,efd->ecd", h, params["wd"])


def _topk(gates, k):
    top_v, top_i = torch.topk(gates, k, dim=-1)
    top_v = top_v / (torch.sum(top_v, dim=-1, keepdim=True) + 1e-9)
    return top_v, top_i


def _route(params, xt, cfg: ModelConfig):
    """Router gates (T, E) fp32 and the normalized top-k (values, ids)."""
    logits = xt.to(torch.float32) @ params["router"]
    gates = torch.softmax(logits, dim=-1)
    return (gates,) + _topk(gates, cfg.moe.num_experts_per_tok)


def _aux_loss(gates, top_i, cfg: ModelConfig):
    """Switch-style load-balance auxiliary loss (token-local estimate)."""
    E = cfg.moe.num_experts
    me = torch.mean(gates, dim=0)
    frac = torch.mean(F.one_hot(top_i[:, 0], E).to(torch.float32), dim=0)
    return torch.sum(me * frac) * E * cfg.moe.router_aux_loss_coef


def capacity_of(T: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    return max(1, int(T * m.num_experts_per_tok * CAPACITY_FACTOR / m.num_experts))


# ---------------------------------------------------------------------------
# sort-based scatter dispatch
# ---------------------------------------------------------------------------


def _moe_local_sort(params, xt, cfg: ModelConfig):
    """xt: (T, D) token block. Returns (y (T, D), aux scalar)."""
    m = cfg.moe
    T, D = xt.shape
    E, k = m.num_experts, m.num_experts_per_tok
    capacity = capacity_of(T, cfg)
    dev = xt.device
    gates, top_v, top_i = _route(params, xt, cfg)

    # Flatten choice-major (j*T + t) so each expert's queue holds all
    # 1st-choice tokens (in token order) before any 2nd-choice token —
    # the capacity-drop order of the einsum oracle.
    e_flat = top_i.T.reshape(-1)                                   # (k*T,)
    w_flat = top_v.T.reshape(-1)
    tok_flat = torch.arange(T, device=dev).repeat(k)

    order = torch.argsort(e_flat, stable=True)                     # token order within expert
    e_sorted = e_flat[order]
    # position of each routed token within its expert's queue
    starts = torch.searchsorted(e_sorted, torch.arange(E, device=dev), side="left")
    pos = torch.arange(T * k, device=dev) - starts[e_sorted]
    keep = pos < capacity
    slot = torch.where(keep, e_sorted * capacity + pos, E * capacity)  # sentinel row

    buf = torch.zeros((E * capacity + 1, D), dtype=xt.dtype, device=dev)
    buf[slot] = xt[tok_flat[order]]
    expert_in = buf[:-1].reshape(E, capacity, D)
    expert_out = _expert_ffn(params, expert_in)
    rows = torch.cat([expert_out.reshape(E * capacity, D),
                      torch.zeros((1, D), dtype=xt.dtype, device=dev)], dim=0)
    routed = rows[slot] * w_flat[order, None].to(xt.dtype)         # (T*k, D)
    y = torch.zeros((T, D), dtype=xt.dtype, device=dev).index_add_(0, tok_flat[order], routed)
    return y, _aux_loss(gates, top_i, cfg)


# ---------------------------------------------------------------------------
# GShard one-hot dispatch (oracle / small models)
# ---------------------------------------------------------------------------


def _moe_local_einsum(params, xt, cfg: ModelConfig):
    m = cfg.moe
    T, D = xt.shape
    E, k = m.num_experts, m.num_experts_per_tok
    capacity = capacity_of(T, cfg)
    dev = xt.device
    gates, top_v, top_i = _route(params, xt, cfg)

    dispatch = torch.zeros((T, E, capacity), dtype=gates.dtype, device=dev)
    combine = torch.zeros((T, E, capacity), dtype=gates.dtype, device=dev)
    counts = torch.zeros((E,), dtype=torch.int32, device=dev)
    for j in range(k):  # unrolled: k is a small static int
        oh = F.one_hot(top_i[:, j], E).to(torch.int32)
        pos = torch.cumsum(oh, dim=0, dtype=torch.int32) - 1 + counts[None, :]
        within = (pos < capacity) & (oh > 0)
        pos_oh = F.one_hot(torch.clamp(pos, 0, capacity - 1).to(torch.int64),
                           capacity).to(gates.dtype)
        slot = pos_oh * within[..., None].to(gates.dtype)
        dispatch = dispatch + slot
        combine = combine + slot * top_v[:, j, None, None]
        counts = counts + torch.sum(oh * within.to(torch.int32), dim=0, dtype=torch.int32)

    expert_in = torch.einsum("tec,td->ecd", dispatch.to(xt.dtype), xt)
    expert_out = _expert_ffn(params, expert_in)
    y = torch.einsum("tec,ecd->td", combine.to(xt.dtype), expert_out)
    return y, _aux_loss(gates, top_i, cfg)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def moe_apply(params, x, cfg: ModelConfig):
    """Returns (y, aux_loss).  x: (B, S, D)."""
    m = cfg.moe
    B, S, D = x.shape
    # without a mesh the expert-parallel schedule falls back to "sort"
    dispatch = "sort" if m.dispatch == "ep" else m.dispatch
    local = _moe_local_sort if dispatch == "sort" else _moe_local_einsum
    y, aux = local(params, x.reshape(-1, D), cfg)
    y = y.reshape(B, S, D)
    if m.num_shared_experts > 0:
        y = y + layers.mlp_apply(params["shared"], x)
    return y, aux
