"""Composable decoder / encoder-decoder transformer (port of
``repro.models.transformer``).

Layers are grouped by the config's cyclic ``block_pattern``: the stack is
``repeats`` copies of the pattern (parameters stacked on a leading axis,
under ``params["scan"]["p{i}_{bt}"]``) plus an unstacked tail
(``params["tail{t}_{bt}"]``) for ``num_layers % len(pattern)`` remainder
layers.  The tree is the reference's, leaf for leaf, so the reference's
params carry across through ``repro_torch.utils.tree.from_jax_params``.  The
reference's ``lax.scan`` over the repeats is a Python loop over the stacked
leaves here.  Its per-block ``jax.checkpoint`` (``cfg.remat``) is
``torch.utils.checkpoint`` around each block of the stack while autograd
records (the encoder's blocks and the MTP head's block stay unwrapped, as
there); under ``torch.no_grad()`` (prefill, serve) each block is called
directly.  Its ``shard_activation`` hints are the reference's: they change
nothing on a plain tensor (``repro_torch.sharding.ctx``).

Entry points:
  * ``init(generator)``                    -> params
  * ``forward(params, batch)``             -> {"logits", "aux_loss"[, "mtp_logits"]}
  * ``init_cache(batch, max_len)``         -> decode cache
  * ``decode_step(params, tok, cache, pos[, memory])`` -> (logits, cache)

Batch dict keys: ``tokens`` (B,S) int64; optional ``prefix_embeds``
(B,P,D) for VLM; ``frames`` (B,T,D) for audio encoder input.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers, moe, recurrent
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.ctx import carried, pvary_manual, shard_activation
from repro_torch.utils.tree import tree_map

ATTN_TYPES = ("attn", "swa", "local")
RECURRENT_TYPES = ("rglru", "mlstm", "slstm")


def _has_ffn(cfg: ModelConfig) -> bool:
    return cfg.d_ff > 0 or cfg.moe is not None


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _index(tree, r: int):
    return tree_map(lambda a: a[r], tree)


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------


def block_init(generator, cfg: ModelConfig, block_type: str, cross: bool = False,
               device=None) -> dict:
    dt = cfg.torch_dtype
    p = {"norm1": layers.rmsnorm_init(cfg.d_model, dt, device)}
    if block_type in ATTN_TYPES:
        p["mixer"] = layers.attention_init(generator, cfg, device)
    elif block_type == "mla":
        p["mixer"] = layers.mla_init(generator, cfg, device)
    elif block_type == "rglru":
        p["mixer"] = recurrent.rglru_init(generator, cfg, device)
    elif block_type == "mlstm":
        p["mixer"] = recurrent.mlstm_init(generator, cfg, device)
    elif block_type == "slstm":
        p["mixer"] = recurrent.slstm_init(generator, cfg, device)
    else:
        raise ValueError(f"unknown block type {block_type}")
    if cross:
        p["norm_x"] = layers.rmsnorm_init(cfg.d_model, dt, device)
        p["cross"] = layers.attention_init(generator, cfg, device)
    if _has_ffn(cfg):
        p["norm2"] = layers.rmsnorm_init(cfg.d_model, dt, device)
        p["ffn"] = (moe.moe_init(generator, cfg, device) if cfg.moe is not None
                    else layers.mlp_init(generator, cfg, device=device))
    return p


def block_apply(params, x, cfg: ModelConfig, block_type: str,
                memory=None, positions=None, causal: bool = True):
    """Full-sequence block. Returns (x, aux_loss)."""
    h = layers.rmsnorm_apply(params["norm1"], x, cfg.norm_eps)
    if block_type in ATTN_TYPES:
        if causal:
            h = layers.attention_apply(params["mixer"], h, cfg, block_type, positions)
        else:
            h = _bidir_attention(params["mixer"], h, cfg, positions)
    elif block_type == "mla":
        h = layers.mla_apply(params["mixer"], h, cfg, positions)
    elif block_type == "rglru":
        h = recurrent.rglru_apply(params["mixer"], h, cfg)
    elif block_type == "mlstm":
        h = recurrent.mlstm_apply(params["mixer"], h, cfg)
    elif block_type == "slstm":
        h = recurrent.slstm_apply(params["mixer"], h, cfg)
    x = x + h
    if "cross" in params and memory is not None:
        h = layers.rmsnorm_apply(params["norm_x"], x, cfg.norm_eps)
        x = x + layers.cross_attention_apply(params["cross"], h, memory, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" in params:
        h = layers.rmsnorm_apply(params["norm2"], x, cfg.norm_eps)
        if cfg.moe is not None:
            h, aux = moe.moe_apply(params["ffn"], h, cfg)
        else:
            h = layers.mlp_apply(params["ffn"], h)
        x = x + h
    return x, aux


def _bidir_attention(params, x, cfg: ModelConfig, positions=None):
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = layers._qkv(params, x, cfg)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    out = layers._gqa_core(q, k, v, torch.ones((1, 1, 1, 1, 1), dtype=torch.bool,
                                                  device=x.device))
    return out.reshape(B, S, -1) @ params["wo"]


def block_init_cache(cfg: ModelConfig, block_type: str, batch: int, max_len: int,
                     device=None) -> dict:
    if block_type in ATTN_TYPES:
        return layers.attention_init_cache(cfg, block_type, batch, max_len, device)
    if block_type == "mla":
        return layers.mla_init_cache(cfg, batch, max_len, device)
    if block_type == "rglru":
        return recurrent.rglru_init_state(cfg, batch, device)
    if block_type == "mlstm":
        return recurrent.mlstm_init_state(cfg, batch, device)
    if block_type == "slstm":
        return recurrent.slstm_init_state(cfg, batch, device)
    raise ValueError(block_type)


def block_decode(params, x, cache, pos: int, cfg: ModelConfig, block_type: str,
                 memory=None, mla_absorbed: bool = False):
    h = layers.rmsnorm_apply(params["norm1"], x, cfg.norm_eps)
    if block_type in ATTN_TYPES:
        h, cache = layers.attention_decode(params["mixer"], h, cache, pos, cfg, block_type)
    elif block_type == "mla":
        fn = layers.mla_decode_absorbed if mla_absorbed else layers.mla_decode
        h, cache = fn(params["mixer"], h, cache, pos, cfg)
    elif block_type == "rglru":
        h, cache = recurrent.rglru_decode(params["mixer"], h, cache, cfg)
    elif block_type == "mlstm":
        h, cache = recurrent.mlstm_decode(params["mixer"], h, cache, cfg)
    elif block_type == "slstm":
        h, cache = recurrent.slstm_decode(params["mixer"], h, cache, cfg)
    x = x + h
    if "cross" in params and memory is not None:
        h = layers.rmsnorm_apply(params["norm_x"], x, cfg.norm_eps)
        x = x + layers.cross_attention_apply(params["cross"], h, memory, cfg)
    if "ffn" in params:
        h = layers.rmsnorm_apply(params["norm2"], x, cfg.norm_eps)
        if cfg.moe is not None:
            h, _ = moe.moe_apply(params["ffn"], h, cfg)
        else:
            h = layers.mlp_apply(params["ffn"], h)
        x = x + h
    return x, cache


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class Transformer:
    """The zoo's model on ``device`` (the GPU unless the caller names
    another)."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        P = len(cfg.block_pattern)
        self.repeats = cfg.num_layers // P
        self.tail_types = cfg.block_pattern[: cfg.num_layers % P]

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        """Random params drawn from ``generator`` (a CPU generator), on the
        model's device."""
        cfg, dev = self.cfg, self.device
        dt = cfg.torch_dtype
        cross = cfg.is_encoder_decoder
        params = {"embed": layers.embed_init(generator, cfg.vocab_size, cfg.d_model, dt, dev)}
        if self.repeats > 0:
            params["scan"] = {
                f"p{i}_{bt}": _stack([block_init(generator, cfg, bt, cross=cross, device=dev)
                                      for _ in range(self.repeats)])
                for i, bt in enumerate(cfg.block_pattern)
            }
        for t, bt in enumerate(self.tail_types):
            params[f"tail{t}_{bt}"] = block_init(generator, cfg, bt, cross=cross, device=dev)
        params["final_norm"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
        if not cfg.tie_embeddings:
            params["unembed"] = layers.dense_init(generator, cfg.d_model, cfg.vocab_size, dt,
                                                  device=dev)
        if cfg.is_encoder_decoder:
            params["encoder"] = {
                "blocks": _stack([block_init(generator, cfg, "attn", device=dev)
                                  for _ in range(cfg.encoder_layers)]),
                "norm": layers.rmsnorm_init(cfg.d_model, dt, dev)}
        if cfg.mtp_depth > 0:
            params["mtp"] = {
                "proj": layers.dense_init(generator, 2 * cfg.d_model, cfg.d_model, dt,
                                          device=dev),
                "block": block_init(generator, cfg, cfg.block_pattern[-1], device=dev),
                "norm": layers.rmsnorm_init(cfg.d_model, dt, dev),
            }
        return params

    # -- encoder ------------------------------------------------------------
    def encode(self, params, frames):
        """frames: (B,T,D) precomputed frontend embeddings (stub carve-out)."""
        cfg = self.cfg
        x = frames.to(cfg.torch_dtype)
        blocks = params["encoder"]["blocks"]
        for r in range(cfg.encoder_layers):
            x, _ = block_apply(_index(blocks, r), x, cfg, "attn", causal=False)
        return layers.rmsnorm_apply(params["encoder"]["norm"], x, cfg.norm_eps)

    # -- embedding ----------------------------------------------------------
    def _embed(self, params, batch):
        cfg = self.cfg
        x = params["embed"][batch["tokens"]]
        if cfg.num_prefix_tokens > 0 and "prefix_embeds" in batch:
            x = torch.cat([batch["prefix_embeds"].to(x.dtype), x], dim=1)
        return shard_activation(x, ("batch", None, None))

    def _unembed(self, params, x):
        cfg = self.cfg
        x = layers.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        logits = x @ w
        return layers.softcap(logits, cfg.logit_softcap)

    def _blocks(self, params):
        """(block params, block type, key) of every layer in order: the
        stacked repeats, then the tail."""
        for r in range(self.repeats):
            for i, bt in enumerate(self.cfg.block_pattern):
                key = f"p{i}_{bt}"
                yield _index(params["scan"][key], r), bt, (r, key)
        for t, bt in enumerate(self.tail_types):
            key = f"tail{t}_{bt}"
            yield params[key], bt, (None, key)

    # -- full-sequence forward ---------------------------------------------
    def forward(self, params, batch, last_logit_only: bool = False):
        """``last_logit_only=True`` is the prefill path: hidden states run
        the full sequence but only the final position is unembedded (the
        vocab matmul dominates otherwise)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        memory = self.encode(params, batch["frames"]) if cfg.is_encoder_decoder else None
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux = pvary_manual(torch.zeros((), dtype=torch.float32, device=x.device))
        remat = cfg.remat and torch.is_grad_enabled()
        # the recompute runs on autograd's thread: carry the mesh state there
        block = moe.carried(carried(block_apply)) if remat else block_apply
        for blk, bt, _ in self._blocks(params):
            if remat:
                x, a = checkpoint(block, blk, x, cfg, bt, memory=memory,
                                  positions=positions, use_reentrant=False)
            else:
                x, a = block_apply(blk, x, cfg, bt, memory=memory, positions=positions)
            aux = aux + a
        logits = self._unembed(params, x[:, -1:] if last_logit_only else x)
        out = {"logits": shard_activation(logits, ("batch", None, "model")), "aux_loss": aux}
        if cfg.mtp_depth > 0 and not last_logit_only:
            out["mtp_logits"] = self._mtp(params, x, batch)
        return out

    def _mtp(self, params, h, batch):
        """DeepSeek-V3 multi-token-prediction head: predict token t+2 from
        the final hidden state at t combined with the embedding of t+1."""
        cfg = self.cfg
        emb_next = params["embed"][batch["tokens"]]
        emb_next = torch.roll(emb_next, -1, dims=1)
        if cfg.num_prefix_tokens > 0 and "prefix_embeds" in batch:
            pad = torch.zeros((h.shape[0], cfg.num_prefix_tokens, cfg.d_model), dtype=h.dtype,
                              device=h.device)
            emb_next = torch.cat([pad, emb_next], dim=1)
        g = torch.cat([layers.rmsnorm_apply(params["mtp"]["norm"], h, cfg.norm_eps),
                       emb_next.to(h.dtype)], dim=-1)
        g = g @ params["mtp"]["proj"]
        g, _ = block_apply(params["mtp"]["block"], g, cfg, cfg.block_pattern[-1])
        return self._unembed(params, g)

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg, dev = self.cfg, self.device
        cache = {}
        if self.repeats > 0:
            cache["scan"] = {
                f"p{i}_{bt}": tree_map(
                    lambda x: x.expand((self.repeats,) + x.shape).clone(),
                    block_init_cache(cfg, bt, batch, max_len, dev))
                for i, bt in enumerate(cfg.block_pattern)}
        for t, bt in enumerate(self.tail_types):
            cache[f"tail{t}_{bt}"] = block_init_cache(cfg, bt, batch, max_len, dev)
        return cache

    def decode_step(self, params, tokens, cache, pos: int, memory=None,
                    mla_absorbed: bool = False):
        """tokens: (B,1) int64; pos: the absolute position (an int)."""
        cfg = self.cfg
        x = params["embed"][tokens]
        x = shard_activation(x, ("batch", None, None))
        scan_caches = {key: [] for key in cache.get("scan", {})}
        new_cache = {}
        for blk, bt, (r, key) in self._blocks(params):
            c = cache[key] if r is None else _index(cache["scan"][key], r)
            x, c = block_decode(blk, x, c, pos, cfg, bt, memory=memory,
                                mla_absorbed=mla_absorbed)
            if r is None:
                new_cache[key] = c
            else:
                scan_caches[key].append(c)
        if scan_caches:
            new_cache["scan"] = {key: _stack(cs) for key, cs in scan_caches.items()}
        logits = self._unembed(params, x)
        return logits, new_cache
