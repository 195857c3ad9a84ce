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

On a mesh under ``repro_torch.sharding.ctx.sharded_params`` (the train,
prefill and serve steps) ``params`` are this rank's blocks under
:meth:`Transformer.param_specs`, the reference's specs.  Each block
gathers its leaves at use, inside the checkpointed block so remat gathers
again: over ``data`` (fsdp, ZeRO-3: the gradient reduce-scattered where
``data`` splits the rows), and over ``model`` except the leaves its layers
compute on split (``_leaf_sets``): attention's heads (causal, the
encoder's unmasked and cross-attention alike), MLA's heads (``wuq``,
``wuk``, ``wuv``), the RG-LRU's channels (``wx``, ``wy``, ``conv_w`` and
the gates' columns), the SwiGLU hidden, the experts and router.  Where
``model`` does not divide the heads but divides ``head_dim``, attention
(and cross-attention) gathers its leaves whole and each rank computes its
``dh/n`` columns of every head, the scores summed over ``model``
(``layers.gqa_core_split``).  A leaf gathered whole or replicated that
every rank uses for its part (those, MLA's down projections and norms,
the RG-LRU's ``lam``, ``conv_b`` and ``wo``) has its gradient summed over
``model``.  A leaf is gathered whole where a layer cannot split (the
mLSTM, the sLSTM, the MTP head's ``proj``, neither heads nor ``head_dim``
divisible).  The embedding is vocab-parallel where ``model`` splits the
vocab (each rank looks up the rows it holds, the others masked to 0, one
all-reduce; :class:`VocabSplit` places every id).  The unembedding, tied
or not, runs split on the vocab or on ``d_model`` (partial logits
all-reduced), as its spec places it; split on the vocab, ``forward(...,
vocab_blocks=True)`` (the loss's) returns the rank's block of the logits
and its :class:`VocabSplit`, and otherwise the blocks are gathered whole
(prefill and serve).

The serve step's :meth:`Transformer.decode_step` on a mesh takes, beside
the param blocks, the rank's rows of the tokens and its blocks of the
cache under :meth:`Transformer.cache_specs` (the reference's
``cache_shardings``).  Attention runs on its cache block as it is
(``head_dim`` split over ``model``, the slots over ``data`` where the
sequence is split: ``layers.attention_decode``); the RG-LRU on its state
blocks (``h`` and ``conv`` hold its channels); cross-attention as in the
full sequence; every other mixer's state (MLA's latent cache, the mLSTM's,
the sLSTM's) is gathered at use and its new state cut back to the block
(storage sharded, compute replicated).

Entry points:
  * ``init(generator)``                    -> params
  * ``forward(params, batch)``             -> {"logits", "aux_loss"[, "mtp_logits"]}
                                             (with ``vocab_blocks``, also "vocab")
  * ``init_cache(batch, max_len)``         -> decode cache
  * ``decode_step(params, tok, cache, pos[, memory])`` -> (logits, cache)

Batch dict keys: ``tokens`` (B,S) int64; optional ``prefix_embeds``
(B,P,D) for VLM; ``frames`` (B,T,D) for audio encoder input.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers, moe, recurrent
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.ctx import (carried, current_mesh_context, model_split, pvary_manual,
                                      shard_activation)
from repro_torch.sharding.specs import (P, cache_specs, entry_axes, leaf_block, map_with_specs,
                                        mesh_shape, param_specs, spec_axes)
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
# a rank's blocks at use
# ---------------------------------------------------------------------------


def _use(leaf, spec, keep_model: bool = False, partial: bool = False):
    """A leaf block as the layers compute on it: gathered over the axes of
    its spec (but ``model`` when ``keep_model``).  The gradient is summed
    over the axes that split the rows and cut to the block over the
    others; over ``model`` too where every rank uses the leaf for its part
    of the work (``partial``)."""
    ctx = current_mesh_context()
    axes = tuple(a for a in spec_axes(spec) if not (keep_model and a == "model"))
    if partial and "model" not in axes:
        leaf = coll.sum_grad(leaf, ctx.mesh, "model")
    if not axes:
        return leaf
    rows = set(ctx.rows) - set(ctx.manual)
    return coll.gather(leaf, ctx.mesh, spec, axes=axes,
                       summed=tuple(a for a in axes if a in rows or (partial and a == "model")))


def _use_tree(params, specs, kept=frozenset(), partial=frozenset(), path=""):
    if isinstance(params, dict):
        return {k: _use_tree(v, specs[k], kept, partial, f"{path}{k}/")
                for k, v in params.items()}
    return _use(params, specs, keep_model=path[:-1] in kept, partial=path[:-1] in partial)


def _attention_split(cfg: ModelConfig, tp):
    """How full-sequence attention computes over ``model``: ``"heads"``
    (head-parallel on the rank's blocks), ``"head_dim"`` (each rank its
    ``dh/n`` columns of every head, the leaves whole) or None (every rank
    every head)."""
    if tp is None:
        return None
    if layers.heads_split(cfg, tp.n):
        return "heads"
    return "head_dim" if layers.head_dim_split(cfg, tp.n) else None


def _mixer_split(cfg: ModelConfig, block_type: str, tp, decode: bool = False):
    """How a block's mixer computes over ``model``: attention as
    :func:`_attention_split` gives (a decode's attention follows its cache
    block instead), MLA ``"heads"`` where ``model`` divides the heads (its
    decode gathers), the RG-LRU ``"channels"`` where ``model`` divides its
    width; None: the mixer's leaves gathered whole."""
    if tp is None:
        return None
    if block_type in ATTN_TYPES:
        return None if decode else _attention_split(cfg, tp)
    if block_type == "mla":
        return "heads" if not decode and cfg.num_heads % tp.n == 0 else None
    if block_type == "rglru":
        return "channels" if recurrent.rglru_width(cfg) % tp.n == 0 else None
    return None


_QKVO = ("wq", "wk", "wv", "wo")
# the leaves a split computes on as the rank's blocks ...
_KEPT = {("attn", "heads"): _QKVO, ("mla", "heads"): ("wuq", "wuk", "wuv", "wo"),
         ("rglru", "channels"): ("wx", "wy", "conv_w", "w_input_gate", "w_rec_gate")}
# ... and those it gathers whole and uses in part on every rank (their
# gradients summed over ``model``)
_PARTIAL = {("attn", "head_dim"): _QKVO + ("bq", "bk", "bv"),
            ("mla", "heads"): ("wdq", "wdkv", "wkr", "q_norm/scale", "kv_norm/scale"),
            ("rglru", "channels"): ("wo",)}


def _leaf_sets(cfg: ModelConfig, block_type: str, tp, mixer, cross):
    """(kept, partial): the leaves of a block (paths within it) its layers
    compute on split over ``model``, and the leaves gathered whole that
    every rank uses for its part."""
    kept, partial = set(), set()
    kind = "attn" if block_type in ATTN_TYPES else block_type
    for sub, k, split in (("mixer", kind, mixer), ("cross", "attn", cross)):
        kept |= {f"{sub}/{n}" for n in _KEPT.get((k, split), ())}
        partial |= {f"{sub}/{n}" for n in _PARTIAL.get((k, split), ())}
    if tp is not None and cfg.moe is not None:
        if moe.experts_split(cfg, tp.n):
            kept |= {"ffn/router", "ffn/wg", "ffn/wu", "ffn/wd"}
        if cfg.moe.num_shared_experts and layers.ffn_split(moe.shared_d_ff(cfg), tp.n):
            kept |= {"ffn/shared/wg", "ffn/shared/wu", "ffn/shared/wd"}
    elif tp is not None and cfg.d_ff > 0 and layers.ffn_split(cfg.d_ff, tp.n):
        kept |= {"ffn/wg", "ffn/wu", "ffn/wd"}
    return frozenset(kept), frozenset(partial)


def _splits(tp, split):
    """(``tp``, ``dh_tp``) of an attention split."""
    return (tp if split == "heads" else None), (tp if split == "head_dim" else None)


def _strip_layer(specs):
    """The per-layer specs of stacked leaves (the stacked axis is never
    sharded)."""
    if isinstance(specs, dict):
        return {k: _strip_layer(v) for k, v in specs.items()}
    return P(*specs[1:])


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
                memory=None, positions=None, causal: bool = True, specs=None):
    """Full-sequence block. Returns (x, aux_loss).  ``specs``: ``params``
    are this rank's blocks under these specs (see the module's docstring)."""
    tp = model_split() if specs is not None else None
    mixer = _mixer_split(cfg, block_type, tp)
    cross = _attention_split(cfg, tp) if memory is not None else None
    kept, partial = _leaf_sets(cfg, block_type, tp, mixer, cross)
    if specs is not None:
        params = _use_tree(params, specs, kept, partial)
    h = layers.rmsnorm_apply(params["norm1"], x, cfg.norm_eps)
    if block_type in ATTN_TYPES:
        a_tp, dh_tp = _splits(tp, mixer)
        h = layers.attention_apply(params["mixer"], h, cfg, block_type, positions,
                                   tp=a_tp, dh_tp=dh_tp, causal=causal)
    elif block_type == "mla":
        h = layers.mla_apply(params["mixer"], h, cfg, positions, tp=tp if mixer else None)
    elif block_type == "rglru":
        h = recurrent.rglru_apply(params["mixer"], h, cfg, tp=tp if mixer else None)
    elif block_type == "mlstm":
        h = recurrent.mlstm_apply(params["mixer"], h, cfg)
    elif block_type == "slstm":
        h = recurrent.slstm_apply(params["mixer"], h, cfg)
    x = x + h
    x = _cross(params, x, memory, cfg, tp, cross)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" in params:
        h = layers.rmsnorm_apply(params["norm2"], x, cfg.norm_eps)
        if cfg.moe is not None:
            h, aux = moe.moe_apply(params["ffn"], h, cfg, tp=tp)
        else:
            h = layers.mlp_apply(params["ffn"], h, tp=tp if "ffn/wg" in kept else None)
        x = x + h
    return x, aux


def _cross(params, x, memory, cfg: ModelConfig, tp, split):
    """The cross-attention residual over ``memory``, split as ``split``
    gives."""
    if "cross" not in params or memory is None:
        return x
    h = layers.rmsnorm_apply(params["norm_x"], x, cfg.norm_eps)
    a_tp, dh_tp = _splits(tp, split)
    return x + layers.cross_attention_apply(params["cross"], h, memory, cfg, tp=a_tp,
                                            dh_tp=dh_tp)


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


def _state_use(state, specs):
    """A mixer's decode state block gathered over every axis but the
    batch's (the rank's rows are the rows it computes)."""
    mesh = current_mesh_context().mesh
    return map_with_specs(lambda x, s: coll.gather_leaf(x, mesh, P(None, *s[1:])), state, specs)


def _state_block(state, specs):
    """The inverse of :func:`_state_use`: the rank's block of a state."""
    mesh = current_mesh_context().mesh
    coord = coll.coordinate(mesh)
    return map_with_specs(lambda x, s: leaf_block(x, P(None, *s[1:]), mesh, coord), state,
                          specs)


def _cache_split(spec, tp):
    """(``head_dim`` split, slot split) of an attention cache block under
    its ``spec`` (B, C, K, dh): the last axis over ``model``, the slots
    over ``data``."""
    dh_tp = tp if spec[-1] == "model" else None
    seq = None
    if spec[1] == "data":
        mesh = current_mesh_context().mesh
        seq = layers.SeqSplit(mesh, coll.axes_size(mesh, "data"), coll.axis_index(mesh, "data"))
    return dh_tp, seq


def _state_split(cache_specs) -> bool:
    """Whether an RG-LRU's decode state blocks hold this rank's channels:
    ``h`` (B, W) and ``conv`` (B, K-1, W) with the last axis, and only it
    past the batch, on ``model``."""
    return (tuple(cache_specs["h"][1:]) == ("model",)
            and tuple(cache_specs["conv"][1:]) == (None, "model"))


def block_decode(params, x, cache, pos: int, cfg: ModelConfig, block_type: str,
                 memory=None, mla_absorbed: bool = False, specs=None, cache_specs=None):
    """One-token block.  ``specs``: ``params`` are this rank's blocks under
    these specs and ``cache`` its block under ``cache_specs`` (see the
    module's docstring)."""
    tp = model_split() if specs is not None else None
    mixer = _mixer_split(cfg, block_type, tp, decode=True)
    if mixer == "channels" and not _state_split(cache_specs):
        mixer = None
    cross = _attention_split(cfg, tp) if memory is not None else None
    kept, partial = _leaf_sets(cfg, block_type, tp, mixer, cross)
    gathered = specs is not None and block_type not in ATTN_TYPES and mixer is None
    if specs is not None:
        params = _use_tree(params, specs, kept, partial)
    if gathered:
        cache = _state_use(cache, cache_specs)
    h = layers.rmsnorm_apply(params["norm1"], x, cfg.norm_eps)
    if block_type in ATTN_TYPES:
        dh_tp, seq = _cache_split(cache_specs["k"], tp) if specs is not None else (None, None)
        h, cache = layers.attention_decode(params["mixer"], h, cache, pos, cfg, block_type,
                                           dh_tp=dh_tp, seq=seq)
    elif block_type == "mla":
        fn = layers.mla_decode_absorbed if mla_absorbed else layers.mla_decode
        h, cache = fn(params["mixer"], h, cache, pos, cfg)
    elif block_type == "rglru":
        h, cache = recurrent.rglru_decode(params["mixer"], h, cache, cfg,
                                          tp=tp if mixer else None)
    elif block_type == "mlstm":
        h, cache = recurrent.mlstm_decode(params["mixer"], h, cache, cfg)
    elif block_type == "slstm":
        h, cache = recurrent.slstm_decode(params["mixer"], h, cache, cfg)
    x = x + h
    x = _cross(params, x, memory, cfg, tp, cross)
    if "ffn" in params:
        h = layers.rmsnorm_apply(params["norm2"], x, cfg.norm_eps)
        if cfg.moe is not None:
            h, _ = moe.moe_apply(params["ffn"], h, cfg, tp=tp)
        else:
            h = layers.mlp_apply(params["ffn"], h, tp=tp if "ffn/wg" in kept else None)
        x = x + h
    if gathered:
        cache = _state_block(cache, cache_specs)
    return x, cache


# ---------------------------------------------------------------------------
# the vocab over ``model``
# ---------------------------------------------------------------------------


class VocabSplit(NamedTuple):
    """How ``model`` splits a vocab axis whose spec entry names ``axes``
    (``("model",)``, or ``("data", "model")`` under fsdp, the first axis
    major): the vocab is cut into blocks, one per digit combination of the
    entry's axes; a rank holds, once gathered over the entry's other axes,
    the blocks of its ``model`` digit in the order of the other digits.
    The embedding's lookup, the tied unembedding and the loss all place
    vocab ids by :meth:`locate`."""
    mesh: object
    axes: tuple
    index: int                       # this rank's index along ``model``
    vocab: int

    def locate(self, ids):
        """(owner, row) of each vocab id: the ``model`` index of the rank
        that holds it, and its row in that rank's gathered block."""
        sizes = mesh_shape(self.mesh)
        n = 1
        for a in self.axes:
            n *= sizes[a]
        blk = self.vocab // n
        b, r = ids // blk, ids % blk
        # the block digits of an id's row, the entry's first axis major
        owner, local, stride, lstride = 0, 0, 1, 1
        for a in reversed(self.axes):
            digit = (b // stride) % sizes[a]
            if a == "model":
                owner = digit
            else:
                local = local + digit * lstride
                lstride *= sizes[a]
            stride *= sizes[a]
        return owner, local * blk + r

    def ids(self, device=None):
        """The vocab ids of this rank's block, in row order."""
        ids = torch.arange(self.vocab, device=device)
        owner, row = self.locate(ids)
        mine = owner == self.index
        out = torch.empty(int(mine.sum()), dtype=ids.dtype, device=device)
        out[row[mine]] = ids[mine]
        return out


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
        self._specs = {}

    def param_specs(self, mesh):
        """The reference's spec of every leaf (``param_specs`` with the
        config's fsdp) on ``mesh``: a rank of the train or prefill step
        holds each leaf's block under it."""
        key = tuple(mesh_shape(mesh).items())
        if key not in self._specs:
            shapes = Transformer(self.cfg, device="meta").init(torch.Generator())
            self._specs[key] = param_specs(shapes, mesh, fsdp=self.cfg.fsdp)
        return self._specs[key]

    def cache_specs(self, mesh, batch: int, max_len: int):
        """The reference's ``cache_shardings`` of the decode cache of
        ``batch`` rows and ``max_len`` slots on ``mesh``: a rank of the
        serve step holds each cache leaf's block under it."""
        key = (tuple(mesh_shape(mesh).items()), batch, max_len)
        if key not in self._specs:
            shapes = Transformer(self.cfg, device="meta").init_cache(batch, max_len)
            self._specs[key] = cache_specs(shapes, mesh)
        return self._specs[key]

    def _sharded_specs(self):
        ctx = current_mesh_context()
        return self.param_specs(ctx.mesh) if ctx is not None and ctx.sharded else None

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
    def encode(self, params, frames, specs=None):
        """frames: (B,T,D) precomputed frontend embeddings (stub carve-out)."""
        cfg = self.cfg
        x = frames.to(cfg.torch_dtype)
        blocks = params["encoder"]["blocks"]
        enc = specs["encoder"] if specs is not None else None
        bspec = _strip_layer(enc["blocks"]) if enc is not None else None
        for r in range(cfg.encoder_layers):
            x, _ = block_apply(_index(blocks, r), x, cfg, "attn", causal=False, specs=bspec)
        norm = params["encoder"]["norm"]
        if enc is not None:
            norm = _use_tree(norm, enc["norm"])
        return layers.rmsnorm_apply(norm, x, cfg.norm_eps)

    # -- embedding ----------------------------------------------------------
    def _vocab_split(self, entry, tp):
        """The :class:`VocabSplit` of a vocab axis whose spec entry is
        ``entry``, where ``model`` splits it; None otherwise."""
        if tp is None or "model" not in entry_axes(entry):
            return None
        return VocabSplit(tp.mesh, entry_axes(entry), tp.index, self.cfg.vocab_size)

    def _lookup(self, params, tokens, specs=None):
        """The embedding rows of ``tokens``.  Where ``model`` splits the
        vocab, vocab-parallel: each rank looks up the rows it holds, the
        others masked to 0, and the ranks' rows are summed (exactly one is
        not 0)."""
        emb = params["embed"]
        if specs is None:
            return emb[tokens]
        spec = specs["embed"]
        vocab = self._vocab_split(spec[0], model_split())
        if vocab is None:
            return _use(emb, spec)[tokens]
        emb = _use(emb, spec, keep_model=True)
        owner, row = vocab.locate(tokens)
        mine = owner == vocab.index
        rows = emb[torch.where(mine, row, 0)]
        rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                              device=rows.device))
        return coll.partial_sum(rows, vocab.mesh, "model")

    def _embed(self, params, batch, specs=None):
        cfg = self.cfg
        x = self._lookup(params, batch["tokens"], specs)
        if cfg.num_prefix_tokens > 0 and "prefix_embeds" in batch:
            x = torch.cat([batch["prefix_embeds"].to(x.dtype), x], dim=1)
        return shard_activation(x, ("batch", None, None))

    def _unembed(self, params, x, specs=None, vocab_blocks: bool = False):
        """(logits, vocab): the logits of ``x``, whole, and None; with
        ``vocab_blocks``, where ``model`` splits the vocab of the
        unembedding (the untied ``unembed``'s columns or the tied
        ``embed``'s rows), this rank's block of the logits and its
        :class:`VocabSplit`."""
        cfg = self.cfg
        norm = params["final_norm"]
        if specs is not None:
            norm = _use_tree(norm, specs["final_norm"])
        x = layers.rmsnorm_apply(norm, x, cfg.norm_eps)
        vocab = None
        if specs is None:
            w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
            logits = x @ w
        elif cfg.tie_embeddings:
            spec = specs["embed"]
            vocab = self._vocab_split(spec[0], model_split()) if vocab_blocks else None
            if vocab is None:
                logits = x @ _use(params["embed"], spec).T
            else:                            # this rank's vocab rows
                x = coll.sum_grad(x, vocab.mesh, "model")
                logits = x @ _use(params["embed"], spec, keep_model=True).T
        else:
            spec, tp = specs["unembed"], model_split()
            split = tp is not None and "model" in spec_axes(spec)
            w = _use(params["unembed"], spec, keep_model=split)
            if not split:
                logits = x @ w
            else:
                x = coll.sum_grad(x, tp.mesh, "model")
                if spec[-1] == "model":     # this rank's vocab columns
                    logits = x @ w
                    if vocab_blocks:
                        vocab = self._vocab_split(spec[-1], tp)
                    else:
                        logits = coll.gather(logits, tp.mesh,
                                             P(*([None] * (x.dim() - 1)), "model"))
                else:                        # this rank's rows of d_model
                    d = w.shape[0]
                    logits = coll.partial_sum(x[..., tp.index * d:(tp.index + 1) * d] @ w,
                                              tp.mesh, "model")
        return layers.softcap(logits, cfg.logit_softcap), vocab

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
    def forward(self, params, batch, last_logit_only: bool = False, vocab_blocks: bool = False):
        """``last_logit_only=True`` is the prefill path: hidden states run
        the full sequence but only the final position is unembedded (the
        vocab matmul dominates otherwise).  ``vocab_blocks=True`` is the
        loss's: on a mesh whose ``model`` splits the vocab the logits (and
        the MTP head's) are this rank's block, ``out["vocab"]`` its
        :class:`VocabSplit` (None where the logits are whole)."""
        cfg = self.cfg
        specs = self._sharded_specs()
        x = self._embed(params, batch, specs)
        memory = self.encode(params, batch["frames"], specs) if cfg.is_encoder_decoder else None
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux = pvary_manual(torch.zeros((), dtype=torch.float32, device=x.device))
        remat = cfg.remat and torch.is_grad_enabled()
        # the recompute runs on autograd's thread: carry the mesh state there
        block = moe.carried(carried(block_apply)) if remat else block_apply
        for blk, bt, (r, key) in self._blocks(params):
            bspec = None
            if specs is not None:
                bspec = specs[key] if r is None else _strip_layer(specs["scan"][key])
            if remat:
                x, a = checkpoint(block, blk, x, cfg, bt, memory=memory,
                                  positions=positions, specs=bspec, use_reentrant=False)
            else:
                x, a = block_apply(blk, x, cfg, bt, memory=memory, positions=positions,
                                   specs=bspec)
            aux = aux + a
        logits, vocab = self._unembed(params, x[:, -1:] if last_logit_only else x, specs,
                                      vocab_blocks)
        out = {"logits": shard_activation(logits, ("batch", None, "model")), "aux_loss": aux}
        if vocab_blocks:
            out["vocab"] = vocab
        if cfg.mtp_depth > 0 and not last_logit_only:
            out["mtp_logits"] = self._mtp(params, x, batch, specs, vocab_blocks)
        return out

    def _mtp(self, params, h, batch, specs=None, vocab_blocks: bool = False):
        """DeepSeek-V3 multi-token-prediction head: predict token t+2 from
        the final hidden state at t combined with the embedding of t+1."""
        cfg = self.cfg
        emb_next = self._lookup(params, batch["tokens"], specs)
        emb_next = torch.roll(emb_next, -1, dims=1)
        if cfg.num_prefix_tokens > 0 and "prefix_embeds" in batch:
            pad = torch.zeros((h.shape[0], cfg.num_prefix_tokens, cfg.d_model), dtype=h.dtype,
                              device=h.device)
            emb_next = torch.cat([pad, emb_next], dim=1)
        mtp = params["mtp"]
        if specs is not None:
            mtp = dict(mtp, norm=_use_tree(mtp["norm"], specs["mtp"]["norm"]),
                       proj=_use(mtp["proj"], specs["mtp"]["proj"]))
        g = torch.cat([layers.rmsnorm_apply(mtp["norm"], h, cfg.norm_eps),
                       emb_next.to(h.dtype)], dim=-1)
        g = g @ mtp["proj"]
        g, _ = block_apply(mtp["block"], g, cfg, cfg.block_pattern[-1],
                           specs=specs["mtp"]["block"] if specs is not None else None)
        return self._unembed(params, g, specs, vocab_blocks)[0]

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
                    mla_absorbed: bool = False, cache_specs=None):
        """tokens: (B,1) int64; pos: the absolute position (an int).  Under
        ``sharded_params`` ``params`` are this rank's blocks, ``tokens``
        (and ``memory``) its rows and ``cache`` its blocks under
        ``cache_specs`` (:meth:`cache_specs` of the whole cache)."""
        cfg = self.cfg
        specs = self._sharded_specs()
        if specs is not None and cache_specs is None:
            raise ValueError("a decode on param blocks needs the specs of its cache blocks")
        x = self._lookup(params, tokens, specs)
        x = shard_activation(x, ("batch", None, None))
        scan_caches = {key: [] for key in cache.get("scan", {})}
        new_cache = {}
        for blk, bt, (r, key) in self._blocks(params):
            c = cache[key] if r is None else _index(cache["scan"][key], r)
            bspec = cspec = None
            if specs is not None:
                bspec = specs[key] if r is None else _strip_layer(specs["scan"][key])
                cspec = (cache_specs[key] if r is None
                         else _strip_layer(cache_specs["scan"][key]))
            x, c = block_decode(blk, x, c, pos, cfg, bt, memory=memory,
                                mla_absorbed=mla_absorbed, specs=bspec, cache_specs=cspec)
            if r is None:
                new_cache[key] = c
            else:
                scan_caches[key].append(c)
        if scan_caches:
            new_cache["scan"] = {key: _stack(cs) for key, cs in scan_caches.items()}
        logits, _ = self._unembed(params, x, specs)
        return logits, new_cache
