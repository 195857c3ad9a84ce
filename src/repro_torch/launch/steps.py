"""Step builders: the LM loss and the federated train step, the prefill
step and the serve (decode) step (port of ``repro.launch.steps``).

The federated train step is the paper's technique on the distributed
runtime.  Every client of the FL fleet is one block of the mesh's client
axes (``data``, plus ``pod`` multi-pod; fsdp configs federate over ``pod``
only).  The port runs one process per mesh rank; a rank holds its client's
params and optimizer state with a leading client axis of 1 (its block of
the reference's ``(C, ...)`` stack), and the aggregation collective is
explicit and selectable:

  cfl       all-reduce over all client axes          (~2w bytes, FedAvg)
  dfl_mesh  all-gather + local mean                  (N*w bytes)
  dfl_ring  (N-1) neighbour permute hops             ((N-1)*w, neighbour links)
  enfed     masked ring-reduce within a              ((k-1)*w, never crosses pod)
            k-neighborhood of the data axis

The reference keeps the ``model`` (and for fsdp configs ``data``) axes in
GSPMD's auto mode; the port runs each rank on its full local replica of
them, which changes no number.  A step given a mesh runs under that mesh's
context (``repro_torch.sharding.use_mesh``), as the reference's callers
trace it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core.topology import AggregationStrategy, aggregate_local
from repro_torch.models import Transformer, cross_entropy_loss
from repro_torch.models.moe import disable_token_local
from repro_torch.optim import adam, apply_updates
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.ctx import current_mesh_context, manual_axes, row_axes, use_mesh
from repro_torch.sharding.specs import P, _path_str, _spec_for, mesh_shape, tree_map_with_path
from repro_torch.utils.tree import tree_leaves, tree_map, value_and_grad

MTP_LOSS_WEIGHT = 0.3


def lm_loss(model: Transformer, params, batch):
    out = model.forward(params, batch)
    logits = out["logits"]
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:  # VLM prefix tokens carry no labels
        logits = logits[:, -labels.shape[1]:]
    loss = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    loss = loss + out["aux_loss"]
    if "mtp_logits" in out:
        mtp = out["mtp_logits"]
        if mtp.shape[1] != labels.shape[1]:
            mtp = mtp[:, -labels.shape[1]:]
        # MTP head predicts token t+2: shift labels left by one more step
        mtp_labels = torch.roll(labels, -1, dims=1)
        loss = loss + MTP_LOSS_WEIGHT * cross_entropy_loss(
            mtp[:, :-1].reshape(-1, mtp.shape[-1]), mtp_labels[:, :-1].reshape(-1))
    return loss


def num_clients(mesh, client_axes) -> int:
    sizes = mesh_shape(mesh)
    return int(np.prod([sizes[a] for a in client_axes])) if client_axes else 1


# ---------------------------------------------------------------------------
# federated parameter/opt-state stacking
# ---------------------------------------------------------------------------


def _tensors(fn):
    """``fn`` on tensor leaves; a host int leaf (the optimizer's step count,
    the same for every client) passes through."""
    return lambda _, x: fn(x) if isinstance(x, torch.Tensor) else x


def stack_for_clients(tree, C: int):
    """Every leaf repeated over a new leading client axis of size C (a copy);
    dicts and NamedTuples (optimizer states) alike."""
    return tree_map_with_path(_tensors(lambda x: x.expand((C,) + tuple(x.shape)).clone()), tree)


def fed_param_shardings(params_shape, mesh, client_axes, fsdp: bool):
    """Specs for client-stacked params: axis 0 over the client axes, the
    remaining axes per the base (TP/FSDP) rules."""
    client = tuple(client_axes)

    def f(path, leaf):
        base = _spec_for(_path_str(path), tuple(leaf.shape[1:]), mesh, fsdp=fsdp)
        inner = [None if (e in client or (isinstance(e, tuple) and set(e) & set(client))) else e
                 for e in base]
        return P(client if len(client) > 1 else client[0], *inner) if client else P(None, *inner)

    return tree_map_with_path(f, params_shape)


def client_block(tree, mesh, client_axes):
    """This rank's block (leading axis 1) of a client-stacked ``(C, ...)``
    tree."""
    c = coll.axis_index(mesh, client_axes) if client_axes else 0
    return tree_map_with_path(_tensors(lambda x: x[c:c + 1]), tree)


def _rows(tree, n: int, i: int):
    return tree_map(lambda x: x.chunk(n, dim=0)[i], tree)


def _batch_size(batch) -> int:
    return int(tree_leaves(batch)[0].shape[0])


@contextlib.contextmanager
def _mesh_context(mesh):
    ctx = current_mesh_context()
    if ctx is not None and ctx.mesh is mesh:
        yield
    else:
        with use_mesh(mesh):
            yield


def _check_device(model: Transformer, *trees):
    want = torch.empty(0, device=model.device).device      # "cuda" -> "cuda:<current>"
    for tree in trees:
        for leaf in tree_leaves(tree):
            if isinstance(leaf, torch.Tensor) and leaf.device != want:
                raise ValueError(f"a tensor on {leaf.device} reached the step of a model on "
                                 f"{model.device}; every rank computes on its model's device")


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def make_federated_train_step(model: Transformer, mesh, strategy: AggregationStrategy,
                              lr: float = 1e-4):
    """Returns (train_step, opt).  train_step(params, opt_state, batch,
    mask) -> (params, opt_state, loss): one FL round of 1 local step + the
    strategy's aggregation collective.

    * ``mesh=None``: one step of Adam on the batch's ``lm_loss`` (the
      reference's step with no client axes on one device).
    * a mesh and client axes (strategy other than ``"none"``): every rank
      of the mesh calls the step with its client's block of params and
      optimizer state (leading axis 1, :func:`client_block`), the global
      batch (the rank takes its client's rows) and the per-client mask;
      it returns the rank's new blocks and the loss averaged over the
      clients.
    * a mesh and no client axes, or ``"none"``: plain data parallel.  Every
      rank holds the whole params and takes its block of the global batch
      over the batch axes (``data``-major, so the blocks of one ``data``
      shard sit on the ``pod`` ranks of one ``data`` index); gradients and
      loss are averaged over the batch axes, as XLA reduces the global
      batch's mean.  A batch whose leading axis the batch axes do not
      divide stays whole on every rank, and nothing is averaged.
    """
    opt = adam(lr)
    client_axes = tuple(strategy.client_axes)
    # the reference's bf16 MoE train steps enter the token-local region
    # through an fp32 boundary cast (models/moe.py)
    needs_guard = (model.cfg.moe is not None
                   and model.cfg.torch_dtype == torch.bfloat16
                   and (model.cfg.fsdp or not client_axes or strategy.kind == "none"))
    tl_guard = disable_token_local if needs_guard else contextlib.nullcontext

    def adam_step(params, opt_state, grads):
        with torch.no_grad():
            upd, opt_state = opt.update(grads, opt_state, params)
            return apply_updates(params, upd), opt_state

    if mesh is None:
        def plain_step(params, opt_state, batch, mask):
            del mask
            with tl_guard():
                loss, grads = value_and_grad(lambda p: lm_loss(model, p, batch), params)
            params, opt_state = adam_step(params, opt_state, grads)
            return params, opt_state, loss

        return plain_step, opt

    sizes = mesh_shape(mesh)

    if not client_axes or strategy.kind == "none":
        bt = tuple(a for a in ("pod", "data") if a in sizes)
        nb = int(np.prod([sizes[a] for a in bt])) if bt else 1
        layout = tuple(reversed(bt))            # data-major over (data, pod)

        def dp_step(params, opt_state, batch, mask):
            del mask
            _check_device(model, params, batch)
            split = nb > 1 and _batch_size(batch) % nb == 0 and _batch_size(batch) > 1
            with _mesh_context(mesh):
                local = _rows(batch, nb, coll.axis_index(mesh, layout)) if split else batch
                with row_axes(layout if split else ()), tl_guard():
                    loss, grads = value_and_grad(lambda p: lm_loss(model, p, local), params)
                if split:
                    grads = tree_map(lambda g: coll.all_reduce(g, mesh, bt) / nb, grads)
                    loss = coll.all_reduce(loss, mesh, bt) / nb
            params, opt_state = adam_step(params, opt_state, grads)
            return params, opt_state, loss

        return dp_step, opt

    C = num_clients(mesh, client_axes)
    squeeze = lambda t: tree_map_with_path(_tensors(lambda x: x[0]), t)
    expand = lambda t: tree_map_with_path(_tensors(lambda x: x[None]), t)

    def train_step(params_blk, opt_blk, batch, mask):
        _check_device(model, params_blk, batch, mask)
        if _batch_size(batch) % C:
            raise ValueError(f"the batch's {_batch_size(batch)} rows do not split over "
                             f"{C} clients")
        p, o = squeeze(params_blk), squeeze(opt_blk)
        with _mesh_context(mesh):
            batch_blk = _rows(batch, C, coll.axis_index(mesh, client_axes))
            with row_axes(client_axes), manual_axes(client_axes), tl_guard():
                loss, grads = value_and_grad(lambda q: lm_loss(model, q, batch_blk), p)
                grads = aggregate_local(grads, mask, mesh, strategy)
                loss = coll.all_reduce(loss, mesh, client_axes) / C
        p, o = adam_step(p, o, grads)
        return expand(p), expand(o), loss

    return train_step, opt


# ---------------------------------------------------------------------------
# prefill / serve steps
# ---------------------------------------------------------------------------


def make_prefill_step(model: Transformer):
    def prefill_step(params, batch):
        out = model.forward(params, batch, last_logit_only=True)
        return out["logits"]

    return prefill_step


def make_serve_step(model: Transformer, mla_absorbed: bool = False):
    def serve_step(params, cache, tokens, pos, memory=None):
        logits, cache = model.decode_step(params, tokens, cache, pos,
                                          memory=memory, mla_absorbed=mla_absorbed)
        return logits, cache

    return serve_step
