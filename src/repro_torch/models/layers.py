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
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.sharding.ctx import shard_activation

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


def _qkv(params, x, cfg: ModelConfig):
    B, S, _ = x.shape
    dh = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, S, cfg.num_heads, dh)
    k = k.reshape(B, S, cfg.num_kv_heads, dh)
    v = v.reshape(B, S, cfg.num_kv_heads, dh)
    return q, k, v


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


def _window_for(block_type: str, cfg: ModelConfig) -> Optional[int]:
    if block_type == "swa":
        return cfg.sliding_window
    if block_type == "local":
        return cfg.local_window
    return None


def attention_apply(params, x, cfg: ModelConfig, block_type: str = "attn",
                    positions=None):
    """Full-sequence causal (optionally windowed) attention."""
    B, S, _ = x.shape
    if positions is None:
        positions = _arange(S, x.device)[None, :]
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = shard_activation(q, ("batch", None, "model", None))
    k = shard_activation(k, ("batch", None, None, None))
    i = _arange(S, x.device)[:, None]
    j = _arange(S, x.device)[None, :]
    mask = j <= i
    window = _window_for(block_type, cfg)
    if window is not None:
        mask = mask & (j > i - window)
    out = _gqa_core(q, k, v, mask[None, None, None])
    out = out.reshape(B, S, -1) @ params["wo"]
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


def attention_decode(params, x, cache, pos: int, cfg: ModelConfig, block_type: str = "attn"):
    """One-token decode. ``pos`` is the absolute position (an int).

    Full attention: cache slot = pos.  Windowed: ring buffer slot = pos % C.
    """
    B, S, _ = x.shape
    assert S == 1
    q, k, v = _qkv(params, x, cfg)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    C = cache["k"].shape[1]
    window = _window_for(block_type, cfg)
    slot = pos if window is None else pos % C
    new_k = _write_slot(cache["k"], slot, k)
    new_v = _write_slot(cache["v"], slot, v)
    valid = _arange(C, x.device) <= (pos if window is None else min(pos, C - 1))
    out = _gqa_core(q, new_k, new_v, valid[None, None, None, None, :])
    out = out.reshape(B, 1, -1) @ params["wo"]
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
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    cq = rmsnorm_apply(params["q_norm"], x @ params["wdq"], cfg.norm_eps)
    q = (cq @ params["wuq"]).reshape(B, S, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_expand_kv(params, c_kv, cfg: ModelConfig):
    """Expand cached latent to per-head k_nope / v."""
    m = cfg.mla
    B, T, _ = c_kv.shape
    H = cfg.num_heads
    k_nope = (c_kv @ params["wuk"]).reshape(B, T, H, m.qk_nope_head_dim)
    v = (c_kv @ params["wuv"]).reshape(B, T, H, m.v_head_dim)
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


def mla_apply(params, x, cfg: ModelConfig, positions=None):
    B, S, _ = x.shape
    if positions is None:
        positions = _arange(S, x.device)[None, :]
    q_nope, q_rope = _mla_q(params, x, positions, cfg)
    c_kv = rmsnorm_apply(params["kv_norm"], x @ params["wdkv"], cfg.norm_eps)
    k_rope = _mla_kv_rope(params, x, positions, cfg)
    k_nope, v = _mla_expand_kv(params, c_kv, cfg)
    i = _arange(S, x.device)[:, None]
    j = _arange(S, x.device)[None, :]
    mask = (j <= i)[None, None]
    out = _mla_core(q_nope, q_rope, k_nope, k_rope, v, mask, cfg)
    out = out.reshape(B, S, -1) @ params["wo"]
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


def cross_attention_apply(params, x, memory, cfg: ModelConfig):
    """Decoder query attends over encoder ``memory`` (B, T, D). No mask."""
    B, S, _ = x.shape
    dh = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(B, S, cfg.num_heads, dh)
    k = (memory @ params["wk"]).reshape(B, memory.shape[1], cfg.num_kv_heads, dh)
    v = (memory @ params["wv"]).reshape(B, memory.shape[1], cfg.num_kv_heads, dh)
    out = _gqa_core(q, k, v, torch.ones((1, 1, 1, 1, 1), dtype=torch.bool, device=x.device))
    return out.reshape(B, S, -1) @ params["wo"]


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


def mlp_apply(params, x):
    h = F.silu(x @ params["wg"]) * (x @ params["wu"])
    h = shard_activation(h, ("batch", None, "model"))
    return h @ params["wd"]


# ---------------------------------------------------------------------------
# logits
# ---------------------------------------------------------------------------


def softcap(logits, cap: float):
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits
