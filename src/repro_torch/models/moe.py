"""Mixture-of-experts layer (port of ``repro.models.moe``).

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

On a mesh (``repro_torch.sharding.use_mesh``, one process per rank):

* ``"ep"`` — the expert-parallel schedule: every ``model`` rank routes its
  tokens, keeps only the slots of its E/n_model experts and all-reduces
  the (T, D) partial output over ``model``, the schedule's one
  collective.  It falls back to ``"sort"`` where the reference does (no
  mesh, no ``model`` axis larger than 1, E not divisible by it, or
  ``model`` manual).
* the token-local wrap — when ``data`` is in the mesh, larger than 1, not
  manual, and divides the batch the reference's region sees, routing runs
  per ``data`` shard: capacity comes from the shard's tokens and ``aux``
  is averaged over ``data``.  The rank reaches the shard's tokens from the
  rows it holds (``MeshContext.rows``): as they are, by slicing a
  replicated batch, or by gathering its rows over ``pod``.
* :func:`disable_token_local` — the fp32 boundary cast of the wrap that
  the reference's bf16 train steps take.

Where the port keeps activations replicated over an axis, every rank of
it computes the same loss; the gradients of values each rank uses for its
own part of the work are summed over the axis
(``repro_torch.sharding.collectives``), so every rank ends with the whole
gradient.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.ctx import current_mesh_context, shard_activation
from repro_torch.sharding.specs import mesh_shape

CAPACITY_FACTOR = 1.25

# The reference's bf16 train steps enter the token-local region through an
# fp32 boundary cast (its XLA-CPU partitioner fails on the bf16 boundary
# under grad); the port keeps the cast so its numbers are the reference's.
_TL_STATE = threading.local()


@contextlib.contextmanager
def disable_token_local():
    """Grad-safe mode: fp32-cast the token-local region's boundary."""
    prev = getattr(_TL_STATE, "off", False)
    _TL_STATE.off = True
    try:
        yield
    finally:
        _TL_STATE.off = prev


def carried(fn):
    """``fn`` under the calling thread's :func:`disable_token_local` on
    whatever thread calls it (see ``repro_torch.sharding.ctx.carried``)."""
    if not getattr(_TL_STATE, "off", False):
        return fn

    def run(*args, **kwargs):
        with disable_token_local():
            return fn(*args, **kwargs)

    return run


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
    expert_in = shard_activation(expert_in, ("expert", None, None))
    expert_out = _expert_ffn(params, expert_in)
    expert_out = shard_activation(expert_out, ("expert", None, None))
    rows = torch.cat([expert_out.reshape(E * capacity, D),
                      torch.zeros((1, D), dtype=xt.dtype, device=dev)], dim=0)
    routed = rows[slot] * w_flat[order, None].to(xt.dtype)         # (T*k, D)
    y = torch.zeros((T, D), dtype=xt.dtype, device=dev).index_add_(0, tok_flat[order], routed)
    return y, _aux_loss(gates, top_i, cfg)


# ---------------------------------------------------------------------------
# the rank's view of a data shard, and the expert-parallel schedule
# ---------------------------------------------------------------------------


def _data_block(x, ctx):
    """The reference's ``data`` shard of the tokens, from the rows this rank
    holds: ``(block, back, replicated)``.  ``back`` maps the block's output
    to the rank's rows; ``replicated`` says whether the ranks of ``data``
    hold one objective (the rows replicated over it) rather than each its
    part of a mean taken after."""
    mesh = ctx.mesh
    extra = tuple(a for a in ctx.rows if a not in ctx.manual)
    if extra == ():
        return (coll.slice_rows(x, mesh, "data"),
                lambda y: coll.gather_rows(y, mesh, "data", False), True)
    if extra == ("data",):
        return x, (lambda y: y), False
    if extra == ("data", "pod"):
        n, i = coll.axes_size(mesh, "pod"), coll.axis_index(mesh, "pod")
        return (coll.gather_rows(x, mesh, "pod", True),
                lambda y: y.chunk(n, dim=0)[i], False)
    raise ValueError(f"rows split over {ctx.rows} (manual {sorted(ctx.manual)}): "
                     "no data shard layout for the token-local MoE")


def _moe_expert_parallel(params, x, cfg: ModelConfig, ctx):
    """Each ``model`` rank routes its tokens and keeps ONLY those assigned
    to the E/n_model experts it owns (``lo = rank * e_local``); the one
    collective is the all-reduce of the (T, D) combined output over
    ``model``.  With ``data`` not manual (``bind_data``) routing runs per
    ``data`` shard and ``aux`` is averaged over ``data``."""
    m = cfg.moe
    mesh = ctx.mesh
    sizes = mesh_shape(mesh)
    B, S, D = x.shape
    E, k = m.num_experts, m.num_experts_per_tok
    n_model = sizes["model"]
    n_data = sizes.get("data", 1)
    bind_data = "data" in sizes and n_data > 1 and "data" not in ctx.manual
    e_local = E // n_model
    lo = coll.axis_index(mesh, "model") * e_local
    xb, back, replicated = _data_block(x, ctx) if bind_data else (x, (lambda y: y), False)
    router, wg, wu, wd = (params[n] for n in ("router", "wg", "wu", "wd"))
    if replicated:  # every data rank routes its own shard with the same weights
        router, wg, wu, wd = (coll.sum_grad(w, mesh, "data") for w in (router, wg, wu, wd))
    # each model rank uses only its experts' slice and its slots' tokens
    wg, wu, wd = (coll.sum_grad(w, mesh, "model")[lo:lo + e_local] for w in (wg, wu, wd))

    xt = xb.reshape(-1, D)
    T = xt.shape[0]
    capacity = capacity_of(T, cfg)
    dev = xt.device
    logits = xt.to(torch.float32) @ router
    gates = torch.softmax(logits, dim=-1)
    top_v, top_i = _topk(gates, k)
    # choice-major flatten: the GShard capacity-drop order (see _moe_local_sort)
    e_flat = top_i.T.reshape(-1)
    w_flat = coll.sum_grad(top_v.T.reshape(-1), mesh, "model")
    tok_flat = torch.arange(T, device=dev).repeat(k)

    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    starts = torch.searchsorted(e_sorted, torch.arange(E, device=dev), side="left")
    pos = torch.arange(T * k, device=dev) - starts[e_sorted]
    mine = (e_sorted >= lo) & (e_sorted < lo + e_local) & (pos < capacity)
    slot = torch.where(mine, (e_sorted - lo) * capacity + pos, e_local * capacity)

    xe = coll.sum_grad(xt, mesh, "model")
    buf = torch.zeros((e_local * capacity + 1, D), dtype=xt.dtype, device=dev)
    buf[slot] = xe[tok_flat[order]]
    expert_in = buf[:-1].reshape(e_local, capacity, D)
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, wg))
    h = h * torch.einsum("ecd,edf->ecf", expert_in, wu)
    expert_out = torch.einsum("ecf,efd->ecd", h, wd)
    rows = torch.cat([expert_out.reshape(e_local * capacity, D),
                      torch.zeros((1, D), dtype=xt.dtype, device=dev)], dim=0)
    routed = rows[slot] * w_flat[order, None].to(xt.dtype)
    y_part = torch.zeros((T, D), dtype=xt.dtype, device=dev).index_add_(
        0, tok_flat[order], routed)
    y = coll.partial_sum(y_part, mesh, "model")          # the ONLY collective

    aux = _aux_loss(gates, top_i, cfg)
    if bind_data:
        aux = coll.mean(aux, mesh, "data", replicated)
    return back(y.reshape(xb.shape)), aux


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


def _ref_batch(x, ctx) -> int:
    """The leading axis of ``x`` as the reference's region sees it: the
    rank's rows times the non-manual axes they are split over."""
    sizes = mesh_shape(ctx.mesh)
    n = 1
    for a in ctx.rows:
        if a not in ctx.manual:
            n *= sizes[a]
    return x.shape[0] * n


def moe_apply(params, x, cfg: ModelConfig):
    """Returns (y, aux_loss).  x: (B, S, D)."""
    m = cfg.moe
    B, S, D = x.shape
    ctx = current_mesh_context()
    sizes = mesh_shape(ctx.mesh) if ctx is not None else {}
    dispatch = m.dispatch
    if dispatch == "ep":
        ok = (ctx is not None and sizes.get("model", 1) > 1
              and m.num_experts % sizes["model"] == 0 and "model" not in ctx.manual)
        if not ok:
            dispatch = "sort"  # no mesh / no model axis: fall back
    if dispatch == "ep":
        y, aux = _moe_expert_parallel(params, x, cfg, ctx)
        if m.num_shared_experts > 0:
            y = y + layers.mlp_apply(params["shared"], x)
        return y, aux
    local = _moe_local_sort if dispatch == "sort" else _moe_local_einsum
    wrap_data = (ctx is not None and sizes.get("data", 1) > 1 and "data" not in ctx.manual
                 and _ref_batch(x, ctx) % sizes["data"] == 0)

    if wrap_data:
        # routing runs token-local over 'data'; only the routed-path params
        # enter the region (the shared expert stays outside)
        f32_boundary = getattr(_TL_STATE, "off", False)
        bdt = torch.float32 if f32_boundary else x.dtype
        xb, back, replicated = _data_block(x.to(bdt), ctx)
        routed = {k: params[k].to(bdt) if f32_boundary else params[k]
                  for k in ("router", "wg", "wu", "wd")}
        if replicated:
            routed = {k: coll.sum_grad(v, ctx.mesh, "data") for k, v in routed.items()}
        yb, aux = local(routed, xb.reshape(-1, D), cfg)
        aux = coll.mean(aux, ctx.mesh, "data", replicated)
        y = back(yb.reshape(xb.shape)).to(x.dtype)
    else:
        y, aux = local(params, x.reshape(-1, D), cfg)
        y = y.reshape(B, S, D)
    if m.num_shared_experts > 0:
        y = y + layers.mlp_apply(params["shared"], x)
    return y, aux
