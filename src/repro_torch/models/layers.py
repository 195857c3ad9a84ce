"""Transformer building blocks (port of ``repro.models.layers``): plain
functions on tensors, parameters as nested dicts in the reference's layout.

Every block exposes two entry points:

* ``*_apply(params, x, ...)``  — full-sequence (training / prefill)
* ``*_decode(params, x, cache, pos, ...)`` — one-token step against a cache

KV caches for windowed attention ("swa" / "local") are ring buffers of the
window size, so a long decode holds O(window) state, not O(seq).  RoPE is
applied at cache-write time with absolute positions, making ring order
irrelevant to the (order-invariant) softmax.  A decode step returns a new
cache and leaves the one it was given as it was, as the reference's
functional update does.

The attention is the reference's jnp math in plain torch products: scores
and softmax in fp32, masked entries filled with -1e30, the scale
``1/sqrt(dh)``.  Initializers draw from an explicit ``torch.Generator`` (on
the CPU) and move to ``device``; the weights are not the reference's draws
(parity tests carry the reference's own params across).

On a mesh whose params are blocks (``repro_torch.sharding.ctx.
model_split``) the layers the reference's hints split over ``model`` are
given ``tp``: attention runs head-parallel (each rank holds the columns of
``wq``/``wk``/``wv`` of its query heads and their kv heads, which the
kv-major head order keeps together), the SwiGLU MLP on its block of the
hidden; MLA on its heads (``wuq``, ``wuk``, ``wuv``; the latents whole,
:func:`mla_heads`); cross-attention as attention, over the whole
``memory``; the output projection, split on either axis, is applied by
:func:`project_out`.  Values replicated over ``model`` that a rank uses
for its part only have their gradients summed over it.

Where ``model`` divides ``head_dim`` but not the heads (and in every
decode on a mesh, whose cache ``cache_shardings`` splits on ``head_dim``)
attention splits ``head_dim`` instead (``dh_tp``): each rank takes its
``dh/n`` columns of every head of q, k and v (RoPE applied whole first:
its pairs straddle the blocks), sums the partial scores over ``model``
before the scale, the mask and the softmax, and projects its columns of
the output through its rows of ``wo`` (:func:`gqa_core_split`,
:func:`project_head_dim`).  A decode whose cache splits the sequence over
``data`` (``seq``) combines the softmax across the ``data`` ranks from
each one's max and sum of exponentials.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.ctx import shard_activation
from repro_torch.sharding.specs import P

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, fan_in: int, fan_out: int,
               dtype=torch.float32, scale: float = 1.0, device=None) -> torch.Tensor:
    """(fan_in, fan_out) normal weights of std ``scale / sqrt(fan_in)``,
    drawn from ``generator`` (on the CPU) and moved to ``device``."""
    std = scale / math.sqrt(fan_in)
    w = torch.randn((fan_in, fan_out), generator=generator, dtype=torch.float32) * std
    return w.to(device=device, dtype=dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=generator, dtype=torch.float32) * 0.02
    return w.to(device=device, dtype=dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(dim: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(params, x, eps=1e-6):
    orig = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].to(torch.float32)).to(orig)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                     # (dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs     # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)


# ---------------------------------------------------------------------------
# GQA attention (full / sliding-window / local)
# ---------------------------------------------------------------------------


def attention_init(generator, cfg: ModelConfig, device=None) -> dict:
    dh = cfg.resolved_head_dim
    dt = cfg.torch_dtype
    p = {
        "wq": dense_init(generator, cfg.d_model, cfg.num_heads * dh, dt, device=device),
        "wk": dense_init(generator, cfg.d_model, cfg.num_kv_heads * dh, dt, device=device),
        "wv": dense_init(generator, cfg.d_model, cfg.num_kv_heads * dh, dt, device=device),
        "wo": dense_init(generator, cfg.num_heads * dh, cfg.d_model, dt, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.num_heads * dh,), dtype=dt, device=device)
        p["bk"] = torch.zeros((cfg.num_kv_heads * dh,), dtype=dt, device=device)
        p["bv"] = torch.zeros((cfg.num_kv_heads * dh,), dtype=dt, device=device)
    return p


def heads_split(cfg: ModelConfig, n: int) -> bool:
    """Whether attention runs head-parallel over a ``model`` axis of ``n``:
    every rank then holds whole kv heads and the query heads of their
    groups."""
    return cfg.num_heads % n == 0 and cfg.num_kv_heads % n == 0


def head_dim_split(cfg: ModelConfig, n: int) -> bool:
    """Whether attention can run split on ``head_dim`` over a ``model``
    axis of ``n``: every rank then takes ``dh/n`` columns of every head."""
    return cfg.resolved_head_dim % n == 0


class SeqSplit(NamedTuple):
    """The ``data`` axis a decode cache splits its slots over: its mesh,
    size and this rank's index along it (each rank holds a contiguous
    ``C/n`` of the ``C`` slots)."""
    mesh: object
    n: int
    index: int


def ffn_split(d_ff: int, n: int) -> bool:
    """Whether a SwiGLU MLP of hidden ``d_ff`` runs on a block of its
    hidden over a ``model`` axis of ``n``."""
    return d_ff % n == 0


def _local_bias(b, width: int, tp):
    """This rank's ``width`` columns of a replicated bias."""
    if tp is None or b.shape[0] == width:
        return b
    return coll.sum_grad(b, tp.mesh, "model")[tp.index * width:(tp.index + 1) * width]


def _qkv(params, x, cfg: ModelConfig, tp=None):
    B, S, _ = x.shape
    dh = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + _local_bias(params["bq"], q.shape[-1], tp)
        k = k + _local_bias(params["bk"], k.shape[-1], tp)
        v = v + _local_bias(params["bv"], v.shape[-1], tp)
    q = q.reshape(B, S, -1, dh)
    k = k.reshape(B, S, -1, dh)
    v = v.reshape(B, S, -1, dh)
    return q, k, v


def project_out(h, w, d_out: int, tp):
    """``h @ w`` where ``h`` holds this rank's block of the hidden columns
    and ``w`` is split over ``model``: on its input like ``h`` (partial
    sums, all-reduced), or on its output (``h`` gathered, each rank's
    output columns gathered).  ``tp`` None: ``h`` and ``w`` whole."""
    if tp is None:
        return h @ w
    if w.shape[0] == h.shape[-1]:
        return coll.partial_sum(h @ w, tp.mesh, "model")
    cols = P(*([None] * (h.dim() - 1)), "model")
    split_out = w.shape[-1] != d_out
    # each rank's output columns use every hidden column: the gathered
    # hidden's gradient is a part per rank, summed back to the block
    h = coll.gather(h, tp.mesh, cols, summed=("model",) if split_out else ())
    y = h @ w
    return coll.gather(y, tp.mesh, cols) if split_out else y


def _gqa_core(q, k, v, mask):
    """q: (B,S,H,dh); k/v: (B,T,K,dh); mask: broadcastable (B,1,1,S,T)."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    qr = q.reshape(B, S, K, G, dh)
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qr.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(torch.float32))
    return out.reshape(B, S, H, dh).to(q.dtype)


def head_dim_block(x, tp):
    """This rank's ``dh/n`` columns of every head of ``x`` (..., dh)."""
    d = x.shape[-1] // tp.n
    return x[..., tp.index * d:(tp.index + 1) * d]


def split_scores(q, k):
    """A part of the fp32 scores (B, K, G, S, T) of q (B,S,H,d) against k
    (B,T,K,d): the whole scores where ``d`` is the whole head, this rank's
    share where q and k hold its columns of every head (summed over
    ``model`` to give the scores)."""
    B, S, H, d = q.shape
    K = k.shape[2]
    qr = q.reshape(B, S, K, H // K, d)
    return torch.einsum("bskgd,btkd->bkgst", qr.to(torch.float32), k.to(torch.float32))


def split_output(scores, v, mask, dh: int, seq: Optional[SeqSplit] = None):
    """The attention output (B, S, H, d) of the summed ``scores`` over v
    (B,T,K,d): ``_gqa_core``'s scale ``1/sqrt(dh)`` (``dh`` the whole
    head), mask and softmax.  ``seq``: v and the scores' last axis hold
    this rank's slots, and the softmax is combined across ``data`` (the
    decode's; its collectives carry no gradient)."""
    B, K, G, S, _ = scores.shape
    scores = torch.where(mask, scores * (1.0 / math.sqrt(dh)), NEG_INF)
    if seq is None:
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(torch.float32))
    else:
        top = coll.all_gather(scores.amax(dim=-1, keepdim=True), seq.mesh, "data").amax(dim=0)
        e = torch.exp(scores - top)
        den = coll.all_reduce(e.sum(dim=-1, keepdim=True), seq.mesh, "data")
        num = coll.all_reduce(torch.einsum("bkgst,btkd->bskgd", e, v.to(torch.float32)),
                              seq.mesh, "data")
        out = num / den.permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, K * G, -1)


def gqa_core_split(q, k, v, mask, dh: int, tp=None, seq: Optional[SeqSplit] = None):
    """``_gqa_core`` split on ``head_dim`` over ``tp`` (q, k, v hold this
    rank's ``dh/n`` columns of every head; the output is its columns of
    every head's output) and, in a decode, on the slots over ``seq``.  The
    partial scores are summed over ``model``; each rank then uses the
    summed scores for its own columns, so their gradient is summed back."""
    scores = split_scores(q, k)
    if tp is not None:
        scores = coll.sum_grad(coll.partial_sum(scores, tp.mesh, "model"), tp.mesh, "model")
    return split_output(scores, v, mask, dh, seq).to(q.dtype)


def project_head_dim(out, wo, tp):
    """``out`` (B, S, H, dh/n), this rank's columns of every head, through
    its rows of the whole ``wo`` (rows ``h*dh + index*dh/n ...``), the
    ranks' partial outputs summed over ``model``."""
    B, S, H, d = out.shape
    rows = wo.reshape(H, tp.n, d, -1)[:, tp.index].reshape(H * d, -1)
    return coll.partial_sum(out.reshape(B, S, H * d) @ rows, tp.mesh, "model")


def _window_for(block_type: str, cfg: ModelConfig) -> Optional[int]:
    if block_type == "swa":
        return cfg.sliding_window
    if block_type == "local":
        return cfg.local_window
    return None


def attention_apply(params, x, cfg: ModelConfig, block_type: str = "attn",
                    positions=None, tp=None, dh_tp=None, causal: bool = True):
    """Full-sequence causal (optionally windowed) attention, or with
    ``causal=False`` unmasked (the encoder's); head-parallel over ``tp``
    (this rank's heads' columns of ``wq``/``wk``/``wv``, ``wo`` split) when
    given; split on ``head_dim`` over ``dh_tp`` (the params whole, each
    rank its ``dh/n`` columns of every head) when given."""
    B, S, _ = x.shape
    if positions is None:
        positions = _arange(S, x.device)[None, :]
    split = tp if tp is not None else dh_tp
    if split is not None:
        x = coll.sum_grad(x, split.mesh, "model")
    q, k, v = _qkv(params, x, cfg, tp)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = shard_activation(q, ("batch", None, "model", None))
    k = shard_activation(k, ("batch", None, None, None))
    i = _arange(S, x.device)[:, None]
    j = _arange(S, x.device)[None, :]
    mask = j <= i if causal else torch.ones((S, S), dtype=torch.bool, device=x.device)
    window = _window_for(block_type, cfg)
    if window is not None:
        mask = mask & (j > i - window)
    if dh_tp is not None:
        q, k, v = (head_dim_block(t, dh_tp) for t in (q, k, v))
        out = gqa_core_split(q, k, v, mask[None, None, None], cfg.resolved_head_dim, dh_tp)
        out = project_head_dim(out, params["wo"], dh_tp)
    else:
        out = _gqa_core(q, k, v, mask[None, None, None])
        out = project_out(out.reshape(B, S, -1), params["wo"], cfg.d_model, tp)
    return shard_activation(out, ("batch", None, None))


def attention_init_cache(cfg: ModelConfig, block_type: str, batch: int, max_len: int,
                         device=None) -> dict:
    dh = cfg.resolved_head_dim
    window = _window_for(block_type, cfg)
    C = max_len if window is None else min(window, max_len)
    dt = cfg.torch_dtype
    return {
        "k": torch.zeros((batch, C, cfg.num_kv_heads, dh), dtype=dt, device=device),
        "v": torch.zeros((batch, C, cfg.num_kv_heads, dh), dtype=dt, device=device),
    }


def _write_slot(buf: torch.Tensor, slot: int, row: torch.Tensor) -> torch.Tensor:
    """``buf`` with ``row`` (B, 1, ...) written at ``[:, slot]``, as a new
    tensor (``lax.dynamic_update_slice``)."""
    out = buf.clone()
    out[:, slot:slot + 1] = row
    return out


def attention_decode(params, x, cache, pos: int, cfg: ModelConfig, block_type: str = "attn",
                     dh_tp=None, seq: Optional[SeqSplit] = None):
    """One-token decode. ``pos`` is the absolute position (an int).

    Full attention: cache slot = pos.  Windowed: ring buffer slot = pos % C.

    On a mesh the params are whole and the cache is this rank's block:
    ``dh_tp``, its ``dh/n`` columns of every kv head (the new token's k and
    v computed whole, RoPE'd, then cut); ``seq``, its ``C/n`` contiguous
    slots of the ``C`` (only the rank that holds the slot writes it).
    """
    B, S, _ = x.shape
    assert S == 1
    q, k, v = _qkv(params, x, cfg)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    if dh_tp is not None:
        q, k, v = (head_dim_block(t, dh_tp) for t in (q, k, v))
    n_loc = cache["k"].shape[1]
    lo = seq.index * n_loc if seq is not None else 0
    C = n_loc * (seq.n if seq is not None else 1)
    window = _window_for(block_type, cfg)
    slot = pos if window is None else pos % C
    if seq is None or lo <= slot < lo + n_loc:
        new_k = _write_slot(cache["k"], slot - lo, k)
        new_v = _write_slot(cache["v"], slot - lo, v)
    else:
        new_k, new_v = cache["k"], cache["v"]
    valid = lo + _arange(n_loc, x.device) <= (pos if window is None else min(pos, C - 1))
    mask = valid[None, None, None, None, :]
    if dh_tp is None and seq is None:
        out = _gqa_core(q, new_k, new_v, mask)
        out = out.reshape(B, 1, -1) @ params["wo"]
    else:
        out = gqa_core_split(q, new_k, new_v, mask, cfg.resolved_head_dim, dh_tp, seq)
        out = (project_head_dim(out, params["wo"], dh_tp) if dh_tp is not None
               else out.reshape(B, 1, -1) @ params["wo"])
    return out, {"k": new_k, "v": new_v}


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V3)
# ---------------------------------------------------------------------------


def mla_init(generator, cfg: ModelConfig, device=None) -> dict:
    m = cfg.mla
    dt = cfg.torch_dtype
    H = cfg.num_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim

    def dense(fan_in, fan_out):
        return dense_init(generator, fan_in, fan_out, dt, device=device)

    return {
        "wdq": dense(cfg.d_model, m.q_lora_rank),
        "q_norm": rmsnorm_init(m.q_lora_rank, dt, device),
        "wuq": dense(m.q_lora_rank, H * qk_dim),
        "wdkv": dense(cfg.d_model, m.kv_lora_rank),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, dt, device),
        "wuk": dense(m.kv_lora_rank, H * m.qk_nope_head_dim),
        "wuv": dense(m.kv_lora_rank, H * m.v_head_dim),
        "wkr": dense(cfg.d_model, m.qk_rope_head_dim),
        "wo": dense(H * m.v_head_dim, cfg.d_model),
    }


def _mla_q(params, x, positions, cfg: ModelConfig):
    """The queries of the heads whose columns ``wuq`` holds (every head, or
    this rank's on a ``model`` split)."""
    m = cfg.mla
    B, S, _ = x.shape
    cq = rmsnorm_apply(params["q_norm"], x @ params["wdq"], cfg.norm_eps)
    q = (cq @ params["wuq"]).reshape(B, S, -1, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_expand_kv(params, c_kv, cfg: ModelConfig):
    """Expand cached latent to per-head k_nope / v (of the heads whose
    columns ``wuk`` and ``wuv`` hold)."""
    m = cfg.mla
    B, T, _ = c_kv.shape
    k_nope = (c_kv @ params["wuk"]).reshape(B, T, -1, m.qk_nope_head_dim)
    v = (c_kv @ params["wuv"]).reshape(B, T, -1, m.v_head_dim)
    return k_nope, v


def _mla_core(q_nope, q_rope, k_nope, k_rope, v, mask, cfg: ModelConfig):
    m = cfg.mla
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    f32 = torch.float32
    s_nope = torch.einsum("bshd,bthd->bhst", q_nope.to(f32), k_nope.to(f32))
    s_rope = torch.einsum("bshd,btd->bhst", q_rope.to(f32), k_rope.to(f32))
    scores = (s_nope + s_rope) * scale
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.to(f32))
    return out.to(q_nope.dtype)


def _mla_kv_rope(params, x, positions, cfg: ModelConfig):
    return apply_rope((x @ params["wkr"])[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]


def mla_heads(params, x, cfg: ModelConfig, positions):
    """The full-sequence MLA output (B, S, H * v_head_dim) of the heads
    whose columns ``wuq``, ``wuk`` and ``wuv`` hold, before ``wo``; the
    latents and the shared rope key are computed whole."""
    B, S, _ = x.shape
    q_nope, q_rope = _mla_q(params, x, positions, cfg)
    c_kv = rmsnorm_apply(params["kv_norm"], x @ params["wdkv"], cfg.norm_eps)
    k_rope = _mla_kv_rope(params, x, positions, cfg)
    k_nope, v = _mla_expand_kv(params, c_kv, cfg)
    i = _arange(S, x.device)[:, None]
    j = _arange(S, x.device)[None, :]
    mask = (j <= i)[None, None]
    return _mla_core(q_nope, q_rope, k_nope, k_rope, v, mask, cfg).reshape(B, S, -1)


def mla_apply(params, x, cfg: ModelConfig, positions=None, tp=None):
    """Full-sequence MLA; head-parallel over ``tp`` when given: ``wuq``,
    ``wuk`` and ``wuv`` hold this rank's heads' columns, the down
    projections and norms are whole (each rank uses them for its heads, so
    their gradients are summed over ``model``), ``wo`` split."""
    if positions is None:
        positions = _arange(x.shape[1], x.device)[None, :]
    if tp is not None:
        x = coll.sum_grad(x, tp.mesh, "model")
    out = project_out(mla_heads(params, x, cfg, positions), params["wo"], cfg.d_model, tp)
    return shard_activation(out, ("batch", None, None))


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    m = cfg.mla
    dt = cfg.torch_dtype
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dt, device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dt, device=device),
    }


def _mla_step_cache(params, x, cache, pos: int, cfg: ModelConfig):
    """The query of one token and the caches with its latent and rope key
    written at ``pos``."""
    B = x.shape[0]
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(params, x, posb, cfg)
    c_kv_t = rmsnorm_apply(params["kv_norm"], x @ params["wdkv"], cfg.norm_eps)
    k_rope_t = _mla_kv_rope(params, x, posb, cfg)
    c_kv = _write_slot(cache["c_kv"], pos, c_kv_t)
    k_rope = _write_slot(cache["k_rope"], pos, k_rope_t)
    return q_nope, q_rope, c_kv, k_rope


def mla_decode(params, x, cache, pos: int, cfg: ModelConfig):
    B, S, _ = x.shape
    assert S == 1
    q_nope, q_rope, c_kv, k_rope = _mla_step_cache(params, x, cache, pos, cfg)
    # Baseline: expand the whole latent cache to per-head K/V each step.
    k_nope, v = _mla_expand_kv(params, c_kv, cfg)
    valid = (_arange(c_kv.shape[1], x.device) <= pos)[None, None, None, :]
    out = _mla_core(q_nope, q_rope, k_nope, k_rope, v, valid, cfg)
    out = out.reshape(B, 1, -1) @ params["wo"]
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode_absorbed(params, x, cache, pos: int, cfg: ModelConfig):
    """Weight-absorbed MLA decode (DeepSeek-V3 §2.1.2 inference form).

    Instead of expanding the latent cache to per-head K/V (which reads
    ``T × H × (qk_nope + v)`` elements per step), fold ``wuk`` into the
    query and ``wuv`` into the output so attention runs directly against
    the rank-``r`` latent: per-step reads drop to ``T × r``.
    """
    m = cfg.mla
    B, S, _ = x.shape
    assert S == 1
    H = cfg.num_heads
    f32 = torch.float32
    q_nope, q_rope, c_kv, k_rope = _mla_step_cache(params, x, cache, pos, cfg)
    wuk = params["wuk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    # q_lat[h] = wuk[:,h,:] @ q_nope[h]  -> query in latent space
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.to(f32), wuk.to(f32))
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    s_lat = torch.einsum("bshr,btr->bhst", q_lat, c_kv.to(f32))
    s_rope = torch.einsum("bshd,btd->bhst", q_rope.to(f32), k_rope.to(f32))
    scores = (s_lat + s_rope) * scale
    valid = (_arange(c_kv.shape[1], x.device) <= pos)[None, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhst,btr->bshr", probs, c_kv.to(f32))
    wuv = params["wuv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bshr,rhd->bshd", ctx_lat, wuv.to(f32))
    out = out.to(x.dtype).reshape(B, 1, -1) @ params["wo"]
    return out, {"c_kv": c_kv, "k_rope": k_rope}


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------


def cross_attention_apply(params, x, memory, cfg: ModelConfig, tp=None, dh_tp=None):
    """Decoder query attends over encoder ``memory`` (B, T, D). No mask.
    Split over ``model`` as :func:`attention_apply` splits: head-parallel
    over ``tp``, on ``head_dim`` over ``dh_tp`` (``memory`` replicated over
    ``model``, its gradient summed as ``x``'s)."""
    B, S, _ = x.shape
    dh = cfg.resolved_head_dim
    split = tp if tp is not None else dh_tp
    if split is not None:
        x = coll.sum_grad(x, split.mesh, "model")
        memory = coll.sum_grad(memory, split.mesh, "model")
    q = (x @ params["wq"]).reshape(B, S, -1, dh)
    k = (memory @ params["wk"]).reshape(B, memory.shape[1], -1, dh)
    v = (memory @ params["wv"]).reshape(B, memory.shape[1], -1, dh)
    mask = torch.ones((1, 1, 1, 1, 1), dtype=torch.bool, device=x.device)
    if dh_tp is not None:
        q, k, v = (head_dim_block(t, dh_tp) for t in (q, k, v))
        return project_head_dim(gqa_core_split(q, k, v, mask, dh, dh_tp), params["wo"], dh_tp)
    out = _gqa_core(q, k, v, mask)
    return project_out(out.reshape(B, S, -1), params["wo"], cfg.d_model, tp)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_init(generator, cfg: ModelConfig, d_ff: Optional[int] = None, device=None) -> dict:
    d_ff = d_ff or cfg.d_ff
    dt = cfg.torch_dtype
    return {
        "wg": dense_init(generator, cfg.d_model, d_ff, dt, device=device),
        "wu": dense_init(generator, cfg.d_model, d_ff, dt, device=device),
        "wd": dense_init(generator, d_ff, cfg.d_model, dt, device=device),
    }


def mlp_apply(params, x, tp=None):
    """SwiGLU; on this rank's block of the hidden over ``tp`` (``wg``,
    ``wu`` split on their output, ``wd`` split) when given."""
    if tp is not None:
        x = coll.sum_grad(x, tp.mesh, "model")
    h = F.silu(x @ params["wg"]) * (x @ params["wu"])
    h = shard_activation(h, ("batch", None, "model"))
    return project_out(h, params["wd"], x.shape[-1], tp)


# ---------------------------------------------------------------------------
# logits
# ---------------------------------------------------------------------------


def softcap(logits, cap: float):
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits
