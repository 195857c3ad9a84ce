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

* the rank's experts — when the params are blocks (``tp``, the steps'
  :func:`repro_torch.sharding.ctx.sharded_params`) and ``model`` divides
  E, each rank holds only its E/n_model experts and its router columns.
  Every dispatch then routes every token as the whole model does (the
  router's (T, E) logits gathered before the softmax; the same routes and
  capacity), computes its experts' slots only and all-reduces the (T, D)
  partial output over ``model``.
* ``"ep"`` — the expert-parallel schedule, that computation on a mesh
  whatever the params: with whole params (the serve step) a rank takes
  its experts' slice of the replica.  It falls back to ``"sort"`` where
  the reference does (no mesh, no ``model`` axis larger than 1, E not
  divisible by it, or ``model`` manual).
* the token-local wrap — when ``data`` is in the mesh, larger than 1, not
  manual, and divides the batch the reference's region sees, routing runs
  per ``data`` shard: capacity comes from the shard's tokens and ``aux``
  is averaged over ``data``.  The rank reaches the shard's tokens from the
  rows it holds (``MeshContext.rows``): as they are, by slicing a
  replicated batch, or by gathering its rows over ``pod``.
* :func:`disable_token_local` — the fp32 boundary cast of the wrap that
  the reference's bf16 train steps take.

Where the activations are replicated over an axis, every rank of it
computes the same loss; the gradients of values each rank uses for its
own part of the work are summed over the axis
(``repro_torch.sharding.collectives``), so every rank ends with the
whole gradient of what it holds.
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
from repro_torch.sharding.specs import P, mesh_shape

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


def experts_split(cfg: ModelConfig, n: int) -> bool:
    """Whether each rank of a ``model`` axis of ``n`` holds E/n experts
    (the reference's spec puts the expert axis, and the router's, on
    ``model`` exactly then)."""
    return cfg.moe.num_experts % n == 0


def shared_d_ff(cfg: ModelConfig) -> int:
    m = cfg.moe
    return (m.d_ff_expert or cfg.d_ff) * m.num_shared_experts


def _route(params, xt, cfg: ModelConfig, split=None):
    """Router gates (T, E) fp32 and the normalized top-k (values, ids).  A
    router holding this rank's experts' columns (``split``) has its logits
    gathered over ``model`` first."""
    logits = xt.to(torch.float32) @ params["router"]
    if logits.shape[-1] != cfg.moe.num_experts:
        logits = coll.gather(logits, split[0], P(None, "model"))
    gates = torch.softmax(logits, dim=-1)
    return (gates,) + _topk(gates, cfg.moe.num_experts_per_tok)


def _route_part(params, xt, cfg: ModelConfig, split):
    """:func:`_route` and the tokens as the experts take them.  With
    ``split`` the rank computes its experts' part only: the tokens (and
    the router's input, when it holds its experts' columns) and the top-k
    values it weighs its slots by have their gradients summed over
    ``model``."""
    if split is None:
        return _route(params, xt, cfg) + (xt,)
    xe = coll.sum_grad(xt, split[0], "model")
    split_router = params["router"].shape[-1] != cfg.moe.num_experts
    gates, top_v, top_i = _route(params, xe if split_router else xt, cfg, split)
    return gates, coll.sum_grad(top_v, split[0], "model"), top_i, xe


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


def _moe_local_sort(params, xt, cfg: ModelConfig, split=None):
    """xt: (T, D) token block. Returns (y (T, D), aux scalar).  ``split``
    (mesh, lo, e_local): ``params`` hold experts ``lo ... lo + e_local``
    only; every token is routed, the rank computes its experts' slots and
    the partial outputs are summed over ``model``."""
    m = cfg.moe
    T, D = xt.shape
    E, k = m.num_experts, m.num_experts_per_tok
    capacity = capacity_of(T, cfg)
    dev = xt.device
    lo, e_loc = (split[1], split[2]) if split else (0, E)
    gates, top_v, top_i, xe = _route_part(params, xt, cfg, split)

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
    if split:
        keep = keep & (e_sorted >= lo) & (e_sorted < lo + e_loc)
    slot = torch.where(keep, (e_sorted - lo) * capacity + pos, e_loc * capacity)  # sentinel

    buf = torch.zeros((e_loc * capacity + 1, D), dtype=xt.dtype, device=dev)
    buf[slot] = xe[tok_flat[order]]
    expert_in = buf[:-1].reshape(e_loc, capacity, D)
    expert_in = shard_activation(expert_in, ("expert", None, None))
    expert_out = _expert_ffn(params, expert_in)
    expert_out = shard_activation(expert_out, ("expert", None, None))
    rows = torch.cat([expert_out.reshape(e_loc * capacity, D),
                      torch.zeros((1, D), dtype=xt.dtype, device=dev)], dim=0)
    routed = rows[slot] * w_flat[order, None].to(xt.dtype)         # (T*k, D)
    y = torch.zeros((T, D), dtype=xt.dtype, device=dev).index_add_(0, tok_flat[order], routed)
    if split:
        y = coll.partial_sum(y, split[0], "model")
    return y, _aux_loss(gates, top_i, cfg)


# ---------------------------------------------------------------------------
# the rank's view of a data shard, and the expert-parallel schedule
# ---------------------------------------------------------------------------


def _data_block(x, ctx):
    """The reference's ``data`` shard of the tokens, from the rows this rank
    holds: ``(block, back, replicated)``.  ``back`` maps the block's output
    to the rank's rows; ``replicated`` says whether the ranks of ``data``
    hold one objective (the rows replicated over it) rather than each its
    part of a mean taken after.  Rows split ``pod``-major over ``("pod",
    "data")`` (the serve step's, as ``batch_input_shardings`` places them)
    carry no gradient."""
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
    if extra == ("pod", "data") and not torch.is_grad_enabled():
        # the serve step's rows, pod-major as the cache's: the data shard
        # is cut from the whole batch, the rank's rows from the whole output
        bt = ("pod", "data")
        n, i = coll.axes_size(mesh, bt), coll.axis_index(mesh, bt)
        whole = coll.all_gather(x, mesh, bt).reshape((-1,) + tuple(x.shape[1:]))
        nd, d = coll.axes_size(mesh, "data"), coll.axis_index(mesh, "data")

        def back(y):
            y = coll.all_gather(y, mesh, "data").reshape((-1,) + tuple(y.shape[1:]))
            return y.chunk(n, dim=0)[i]

        return whole.chunk(nd, dim=0)[d], back, False
    raise ValueError(f"rows split over {ctx.rows} (manual {sorted(ctx.manual)}): "
                     "no data shard layout for the token-local MoE")


def _moe_expert_parallel(params, x, cfg: ModelConfig, ctx, tp=None):
    """Each ``model`` rank routes its tokens and keeps ONLY those assigned
    to the E/n_model experts it owns (``lo = rank * e_local``); the one
    collective is the all-reduce of the (T, D) combined output over
    ``model``.  With ``data`` not manual (``bind_data``) routing runs per
    ``data`` shard and ``aux`` is averaged over ``data``.  ``tp`` None:
    ``params`` are whole, and the rank takes its experts' slice."""
    mesh = ctx.mesh
    sizes = mesh_shape(mesh)
    D = x.shape[-1]
    E = cfg.moe.num_experts
    n_data = sizes.get("data", 1)
    bind_data = "data" in sizes and n_data > 1 and "data" not in ctx.manual
    e_local = E // sizes["model"]
    lo = coll.axis_index(mesh, "model") * e_local
    xb, back, replicated = _data_block(x, ctx) if bind_data else (x, (lambda y: y), False)
    routed = {n: params[n] for n in ("router", "wg", "wu", "wd")}
    if replicated:  # every data rank routes its own shard with the same weights
        routed = {n: coll.sum_grad(w, mesh, "data") for n, w in routed.items()}
    if tp is None:  # a whole replica: each model rank uses only its experts' slice
        routed.update({n: coll.sum_grad(routed[n], mesh, "model")[lo:lo + e_local]
                       for n in ("wg", "wu", "wd")})
    y, aux = _moe_local_sort(routed, xb.reshape(-1, D), cfg, (mesh, lo, e_local))
    if bind_data:
        aux = coll.mean(aux, mesh, "data", replicated)
    return back(y.reshape(xb.shape)), aux


# ---------------------------------------------------------------------------
# GShard one-hot dispatch (oracle / small models)
# ---------------------------------------------------------------------------


def _moe_local_einsum(params, xt, cfg: ModelConfig, split=None):
    """The GShard dispatch of ``_moe_local_sort``'s routes, ``split`` as
    there."""
    m = cfg.moe
    T, D = xt.shape
    E, k = m.num_experts, m.num_experts_per_tok
    capacity = capacity_of(T, cfg)
    dev = xt.device
    gates, top_v, top_i, xe = _route_part(params, xt, cfg, split)

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

    if split:  # this rank's experts
        lo, e_loc = split[1], split[2]
        dispatch, combine = dispatch[:, lo:lo + e_loc], combine[:, lo:lo + e_loc]
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(xt.dtype), xe)
    expert_out = _expert_ffn(params, expert_in)
    y = torch.einsum("tec,ecd->td", combine.to(xt.dtype), expert_out)
    if split:
        y = coll.partial_sum(y, split[0], "model")
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


def moe_apply(params, x, cfg: ModelConfig, tp=None):
    """Returns (y, aux_loss).  x: (B, S, D).  ``tp``: the ``model`` axis
    when ``params`` are this rank's blocks (its experts and router columns
    where ``model`` divides E, its shared expert's hidden block)."""
    m = cfg.moe
    B, S, D = x.shape
    ctx = current_mesh_context()
    sizes = mesh_shape(ctx.mesh) if ctx is not None else {}
    etp = tp if tp is not None and experts_split(cfg, tp.n) else None
    stp = tp if tp is not None and layers.ffn_split(shared_d_ff(cfg), tp.n) else None
    split = (tp.mesh, tp.index * (m.num_experts // tp.n), m.num_experts // tp.n) \
        if etp is not None else None
    dispatch = m.dispatch
    if dispatch == "ep":
        ok = (ctx is not None and sizes.get("model", 1) > 1
              and m.num_experts % sizes["model"] == 0 and "model" not in ctx.manual)
        if not ok:
            dispatch = "sort"  # no mesh / no model axis: fall back
    if dispatch == "ep":
        y, aux = _moe_expert_parallel(params, x, cfg, ctx, etp)
        if m.num_shared_experts > 0:
            y = y + layers.mlp_apply(params["shared"], x, tp=stp)
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
        yb, aux = local(routed, xb.reshape(-1, D), cfg, split)
        aux = coll.mean(aux, ctx.mesh, "data", replicated)
        y = back(yb.reshape(xb.shape)).to(x.dtype)
    else:
        y, aux = local(params, x.reshape(-1, D), cfg, split)
        y = y.reshape(B, S, D)
    if m.num_shared_experts > 0:
        y = y + layers.mlp_apply(params["shared"], x, tp=stp)
    return y, aux
