"""Abstract input factories + sharding rules for every step kind (port of
``repro.launch.inputs``).

Everything here lives on the ``meta`` device (shapes and dtypes, no
storage): the dry run runs ``train_step`` / ``prefill_step`` /
``serve_step`` on these.  Token ids are int64, the port's index dtype
(the reference's are int32).  The modality-frontend carve-out lives here
too: audio gets precomputed frame embeddings, VLM gets precomputed patch
embeddings.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import Transformer
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.specs import P, _key_str, mesh_shape, tree_map_with_path

META = torch.device("meta")


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _batch_tuple(mesh):
    sizes = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _nb(mesh):
    sizes = mesh_shape(mesh)
    bt = _batch_tuple(mesh)
    return int(np.prod([sizes[a] for a in bt])) if bt else 1


# ---------------------------------------------------------------------------
# token / frontend inputs
# ---------------------------------------------------------------------------


def train_inputs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    d = {
        "tokens": _empty((batch, seq), torch.int64),
        "labels": _empty((batch, seq), torch.int64),
    }
    if cfg.frontend == "audio":
        d["frames"] = _empty((batch, seq, cfg.d_model), cfg.torch_dtype)
    if cfg.frontend == "vision":
        d["prefix_embeds"] = _empty((batch, cfg.num_prefix_tokens, cfg.d_model),
                                    cfg.torch_dtype)
    return d


def prefill_inputs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    d = train_inputs(cfg, batch, seq)
    del d["labels"]
    return d


def decode_inputs(cfg: ModelConfig, batch: int) -> Dict[str, torch.Tensor]:
    return {"tokens": _empty((batch, 1), torch.int64)}


def decode_memory(cfg: ModelConfig, batch: int, seq: int) -> Optional[torch.Tensor]:
    """Encoder memory for enc-dec decode (frames already encoded)."""
    if cfg.is_encoder_decoder:
        return _empty((batch, seq, cfg.d_model), cfg.torch_dtype)
    return None


def cache_shapes(model: Transformer, batch: int, max_len: int):
    """The decode cache of ``model``'s config on the ``meta`` device."""
    return Transformer(model.cfg, device=META).init_cache(batch, max_len)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------


def batch_input_shardings(inputs, mesh, client_stacked: bool = False,
                          client_axes: Tuple[str, ...] = ()):
    """Inputs shard their leading batch axis over ('pod','data') — or over
    the client axes when feeding the federated (client-stacked) step."""
    if client_stacked and client_axes:
        spec0 = client_axes if len(client_axes) > 1 else client_axes[0]
    else:
        bt = _batch_tuple(mesh)
        spec0 = (bt if len(bt) > 1 else (bt[0] if bt else None))
    nb = max(_nb(mesh), 1)

    def f(path, leaf):
        axes = [None] * len(leaf.shape)
        if axes and leaf.shape[0] % nb == 0 and leaf.shape[0] > 1:
            axes[0] = spec0
        return P(*axes)

    return tree_map_with_path(f, inputs)


def cache_shardings(cache, mesh):
    """Decode-state sharding heuristics:

    * stacked-layer leading axis (scan subtrees) never sharded;
    * batch axis over ('pod','data') when divisible;
    * otherwise a long (>=2048) sequence axis is sharded over 'data'
      (sequence-parallel decode for global_batch=1 long-context);
    * the innermost axis is tensor-parallel over 'model' when divisible.
    """
    sizes = mesh_shape(mesh)
    bt = _batch_tuple(mesh)
    nb = _nb(mesh)
    model_n = sizes.get("model", 1)
    data_n = sizes.get("data", 1)

    def f(path, leaf):
        keys = [_key_str(k) for k in path]
        start = 1 if "scan" in keys else 0
        shape = tuple(leaf.shape)
        axes = [None] * len(shape)
        if len(shape) > start and shape[start] > 1 and shape[start] % nb == 0:
            axes[start] = bt if len(bt) > 1 else bt[0]
        else:
            for j in range(start + 1, len(shape)):
                if shape[j] >= 2048 and data_n > 1 and shape[j] % data_n == 0:
                    axes[j] = "data"
                    break
        last = len(shape) - 1
        if last > start and axes[last] is None and model_n > 1 and shape[last] % model_n == 0:
            axes[last] = "model"
        return P(*axes)

    return tree_map_with_path(f, cache)
