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
GSPMD's auto mode.  The port executes them sharded: a rank holds, of
every param and Adam leaf, only the block that the reference's spec gives
its device (:func:`client_block` under ``fed_param_shardings``,
:func:`param_block` under ``param_specs``), Adam runs on the blocks, and
the model computes split over ``model`` where the reference's hints place
it and gathers a leaf at use elsewhere (``repro_torch.models.
transformer``).  Under fsdp ``data`` is ZeRO-3: the rows split over it,
a leaf's ``data`` blocks gathered at use and its gradient reduce-scattered
back; without fsdp the ``model`` ranks of one client compute on the same
rows, so a gathered leaf's gradient is cut to the block, not summed.
Where ``model`` splits the vocab the logits stay in blocks and
:func:`lm_loss` is vocab-parallel (:func:`vocab_cross_entropy`: the rows'
maxima gathered, the sums of exponentials and the labels' logits summed
over ``model``), as GSPMD takes the reference's log-softmax over the
logits' ``model`` blocks.  Adam's blocks are the reference's placements
of its state, which differ from the params' for an encoder's per-layer
1-D leaves (``_AdamLayout``).  The
serve step holds the same param blocks and its blocks of the decode cache
under ``cache_shardings`` (:func:`cache_block`).  A step given a mesh
runs under that mesh's context
(``repro_torch.sharding.use_mesh``), as the reference's callers trace it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core.topology import AggregationStrategy, aggregate_local, gather_clients
from repro_torch.models import Transformer, cross_entropy_loss
from repro_torch.models.moe import disable_token_local
from repro_torch.optim import adam, apply_updates
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.ctx import (current_mesh_context, manual_axes, row_axes,
                                      sharded_params, use_mesh)
from repro_torch.sharding.specs import (P, _path_str, _spec_for, cache_specs, leaf_block,
                                        leaves_with_path, map_with_specs, mesh_shape,
                                        param_specs, spec_axes, tree_block, tree_map_with_path)
from repro_torch.utils.tree import tree_leaves, tree_map, value_and_grad

MTP_LOSS_WEIGHT = 0.3


def vocab_terms(logits, labels, top, vocab):
    """A rank's part of the two sums of a cross-entropy whose vocab
    ``model`` splits, on its block of ``logits`` (N, V/n) (fp32): the sum
    over its columns of ``exp(logit - top)`` (``top`` the rows' maxima over
    every block) and the label's logit where it holds the label, 0
    elsewhere."""
    s = torch.exp(logits - top[:, None]).sum(dim=-1)
    owner, col = vocab.locate(labels)
    mine = owner == vocab.index
    lab = torch.gather(logits, -1, torch.where(mine, col, 0)[:, None])[:, 0]
    return s, torch.where(mine, lab, torch.zeros((), dtype=lab.dtype, device=lab.device))


def vocab_cross_entropy(logits, labels, vocab):
    """``cross_entropy_loss`` on this rank's block of the logits (N, V/n)
    and its :class:`~repro_torch.models.transformer.VocabSplit`: the rows'
    maxima gathered over ``model`` (no gradient: the loss does not depend
    on them), the sums of exponentials and the labels' logits summed over
    ``model``, then ``mean(log(sum) + max - label logit)`` in fp32."""
    x = logits.to(torch.float32)
    top = coll.all_gather(x.detach().amax(dim=-1), vocab.mesh, "model").amax(dim=0)
    s, lab = vocab_terms(x, labels.long(), top, vocab)
    s = coll.partial_sum(s, vocab.mesh, "model")
    lab = coll.partial_sum(lab, vocab.mesh, "model")
    return torch.mean(torch.log(s) + top - lab)


def lm_loss(model: Transformer, params, batch):
    """The next-token loss (and the MTP head's).  On a mesh whose ``model``
    splits the vocab the logits stay in blocks, the loss
    :func:`vocab_cross_entropy`; elsewhere ``cross_entropy_loss`` on the
    whole logits."""
    out = model.forward(params, batch, vocab_blocks=True)
    vocab = out["vocab"]

    def ce(logits, labels):
        logits, labels = logits.reshape(-1, logits.shape[-1]), labels.reshape(-1)
        if vocab is None:
            return cross_entropy_loss(logits, labels)
        return vocab_cross_entropy(logits, labels, vocab)

    logits = out["logits"]
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:  # VLM prefix tokens carry no labels
        logits = logits[:, -labels.shape[1]:]
    loss = ce(logits, labels)
    loss = loss + out["aux_loss"]
    if "mtp_logits" in out:
        mtp = out["mtp_logits"]
        if mtp.shape[1] != labels.shape[1]:
            mtp = mtp[:, -labels.shape[1]:]
        # MTP head predicts token t+2: shift labels left by one more step
        mtp_labels = torch.roll(labels, -1, dims=1)
        loss = loss + MTP_LOSS_WEIGHT * ce(mtp[:, :-1], mtp_labels[:, :-1])
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


def _inner_spec(path: str, shape, mesh, client, fsdp: bool) -> P:
    """The base (TP/FSDP) spec of a client's leaf, the client axes left out."""
    return P(*[None if (e in client or (isinstance(e, tuple) and set(e) & set(client))) else e
               for e in _spec_for(path, tuple(shape), mesh, fsdp=fsdp)])


def fed_param_shardings(params_shape, mesh, client_axes, fsdp: bool):
    """Specs for client-stacked params: axis 0 over the client axes, the
    remaining axes per the base (TP/FSDP) rules."""
    client = tuple(client_axes)

    def f(path, leaf):
        # a host int leaf (the optimizer's step count) is a scalar
        inner = _inner_spec(_path_str(path), tuple(getattr(leaf, "shape", (1,)))[1:], mesh,
                            client, fsdp)
        return P(client if len(client) > 1 else client[0], *inner) if client else P(None, *inner)

    return tree_map_with_path(f, params_shape)


def client_block(tree, mesh, client_axes, fsdp: bool):
    """This rank's block of a client-stacked ``(C, ...)`` tree under
    ``fed_param_shardings``: its client's (leading axis 1) and, of that,
    the block of each leaf that the reference's spec gives the rank's
    device."""
    specs = fed_param_shardings(tree, mesh, client_axes, fsdp)
    return tree_block(tree, specs, mesh, coll.coordinate(mesh))


def param_block(tree, mesh, fsdp: bool):
    """This rank's block of every leaf of a params (or optimizer-state)
    tree under ``param_specs``: what the data-parallel step and the
    prefill step take on a mesh."""
    return tree_block(tree, param_specs(tree, mesh, fsdp=fsdp), mesh, coll.coordinate(mesh))


def cache_block(cache, mesh):
    """This rank's block of every leaf of a whole decode cache under
    ``inputs.cache_shardings`` (the reference's placement): what the serve
    step takes and returns on a mesh."""
    return tree_block(cache, cache_specs(cache, mesh), mesh, coll.coordinate(mesh))


def gather_cache(blocks, model: Transformer, mesh, batch: int, max_len: int):
    """The inverse of :func:`cache_block` for a cache of ``batch`` rows and
    ``max_len`` slots: every leaf whole, on every rank (for checks; one
    all-gather per sharded tensor axis)."""
    specs = model.cache_specs(mesh, batch, max_len)
    return map_with_specs(lambda x, s: coll.gather_leaf(x, mesh, s), blocks, specs)


def gather_params(blocks, model: Transformer, mesh, client_axes=()):
    """The inverse of :func:`param_block` (and, with ``client_axes``, of
    :func:`client_block`, the clients stacked ``(C, ...)``) for a params
    tree: every leaf whole, on every rank (for checks; one all-gather per
    sharded leaf)."""
    specs = model.param_specs(mesh)
    if client_axes:
        whole = map_with_specs(lambda x, s: coll.gather_leaf(x, mesh, P(None, *s)), blocks,
                               specs)
        return gather_clients(whole, mesh, client_axes)
    return map_with_specs(lambda x, s: coll.gather_leaf(x, mesh, s), blocks, specs)


class _AdamLayout:
    """The leaves whose Adam blocks the reference places otherwise than the
    params: a per-layer 1-D leaf of the encoder (``encoder/blocks/...``,
    (layers, D)) is replicated, but under an optimizer state's path the
    rules do not see its stacked axis and split its last over ``model``.
    Adam runs on the Adam blocks: the gradient (and the param) cut to them,
    the update gathered back to the param's block."""

    def __init__(self, model: Transformer, mesh, client_axes, fsdp: bool):
        self.mesh, self.specs = mesh, {}
        shapes = Transformer(model.cfg, device="meta").init(torch.Generator())
        for path, leaf in leaves_with_path(shapes):
            ps, os = (_inner_spec(pre + path, leaf.shape, mesh, tuple(client_axes), fsdp)
                      for pre in ("", ".mu/"))
            if ps != os:
                self.specs[path] = (ps, os)

    def _move(self, tree, src: int):
        coord = coll.coordinate(self.mesh)

        def f(path, x):
            specs = self.specs.get(_path_str(path))
            if specs is None:
                return x
            whole = coll.gather_leaf(x, self.mesh, specs[src])
            return leaf_block(whole, specs[1 - src], self.mesh, coord)

        return tree_map_with_path(f, tree)

    def to_adam(self, tree):
        return self._move(tree, 0)

    def to_params(self, tree):
        return self._move(tree, 1)


def _mean_over_rows(grads, specs, mesh, axes, n: int):
    """The mean of every leaf's gradient over the ``n`` row blocks that
    ``axes`` split: a leaf sharded over one of them had its gradient summed
    over it by its gather's backward (reduce-scatter), the rest is one
    all-reduce here."""
    def f(g, spec):
        rest = tuple(a for a in axes if a not in spec_axes(spec))
        return (coll.all_reduce(g, mesh, rest) if rest else g) / n

    return map_with_specs(f, grads, specs)


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
      of the mesh calls the step with its block of its client's params and
      optimizer state (:func:`client_block`), the global batch (the rank
      takes its client's rows, and under fsdp its ``data`` block of them)
      and the per-client mask; it returns the rank's new blocks and the
      loss averaged over the clients.
    * a mesh and no client axes, or ``"none"``: plain data parallel.  Every
      rank holds its blocks of the params (:func:`param_block`) and takes
      its block of the global batch over the batch axes (``data``-major,
      so the blocks of one ``data`` shard sit on the ``pod`` ranks of one
      ``data`` index); gradients and loss are averaged over the batch
      axes, as XLA reduces the global batch's mean.  A batch whose leading
      axis the batch axes do not divide stays whole on every rank, and
      nothing is averaged.
    """
    opt = adam(lr)
    client_axes = tuple(strategy.client_axes)
    # the reference's bf16 MoE train steps enter the token-local region
    # through an fp32 boundary cast (models/moe.py)
    needs_guard = (model.cfg.moe is not None
                   and model.cfg.torch_dtype == torch.bfloat16
                   and (model.cfg.fsdp or not client_axes or strategy.kind == "none"))
    tl_guard = disable_token_local if needs_guard else contextlib.nullcontext

    def adam_step(params, opt_state, grads, layout=None):
        with torch.no_grad():
            if layout is None or not layout.specs:
                upd, opt_state = opt.update(grads, opt_state, params)
            else:
                upd, opt_state = opt.update(layout.to_adam(grads), opt_state,
                                            layout.to_adam(params))
                upd = layout.to_params(upd)
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
    specs = model.param_specs(mesh)
    clash = {a for _, s in leaves_with_path(specs) for a in spec_axes(s)} & set(client_axes)
    if clash and strategy.kind != "none":
        raise ValueError(f"the specs shard params over the client axes {sorted(clash)}")

    if not client_axes or strategy.kind == "none":
        adam_layout = _AdamLayout(model, mesh, (), model.cfg.fsdp)
        bt = tuple(a for a in ("pod", "data") if a in sizes)
        nb = int(np.prod([sizes[a] for a in bt])) if bt else 1
        layout = tuple(reversed(bt))            # data-major over (data, pod)

        def dp_step(params, opt_state, batch, mask):
            del mask
            _check_device(model, params, batch)
            split = nb > 1 and _batch_size(batch) % nb == 0 and _batch_size(batch) > 1
            with _mesh_context(mesh), sharded_params():
                local = _rows(batch, nb, coll.axis_index(mesh, layout)) if split else batch
                with row_axes(layout if split else ()), tl_guard():
                    loss, grads = value_and_grad(lambda p: lm_loss(model, p, local), params)
                if split:
                    grads = _mean_over_rows(grads, specs, mesh, bt, nb)
                    loss = coll.all_reduce(loss, mesh, bt) / nb
            params, opt_state = adam_step(params, opt_state, grads, adam_layout)
            return params, opt_state, loss

        return dp_step, opt

    C = num_clients(mesh, client_axes)
    # under fsdp a client's ranks along data are ZeRO-3 data parallel
    inner = ("data",) if (model.cfg.fsdp and sizes.get("data", 1) > 1
                          and "data" not in client_axes) else ()
    n_in = sizes["data"] if inner else 1
    adam_layout = _AdamLayout(model, mesh, client_axes, model.cfg.fsdp)
    squeeze = lambda t: tree_map_with_path(_tensors(lambda x: x[0]), t)
    expand = lambda t: tree_map_with_path(_tensors(lambda x: x[None]), t)

    def train_step(params_blk, opt_blk, batch, mask):
        _check_device(model, params_blk, batch, mask)
        if _batch_size(batch) % C:
            raise ValueError(f"the batch's {_batch_size(batch)} rows do not split over "
                             f"{C} clients")
        p, o = squeeze(params_blk), squeeze(opt_blk)
        with _mesh_context(mesh), sharded_params():
            batch_blk = _rows(batch, C, coll.axis_index(mesh, client_axes))
            split = n_in > 1 and _batch_size(batch_blk) % n_in == 0 and _batch_size(batch_blk) > 1
            if split:
                batch_blk = _rows(batch_blk, n_in, coll.axis_index(mesh, inner))
            rows = client_axes + (inner if split else ())
            with row_axes(rows), manual_axes(client_axes), tl_guard():
                loss, grads = value_and_grad(lambda q: lm_loss(model, q, batch_blk), p)
                if split:
                    grads = _mean_over_rows(grads, specs, mesh, inner, n_in)
                    loss = coll.all_reduce(loss, mesh, inner) / n_in
                grads = aggregate_local(grads, mask, mesh, strategy)
                loss = coll.all_reduce(loss, mesh, client_axes) / C
        p, o = adam_step(p, o, grads, adam_layout)
        return expand(p), expand(o), loss

    return train_step, opt


# ---------------------------------------------------------------------------
# prefill / serve steps
# ---------------------------------------------------------------------------


def make_prefill_step(model: Transformer):
    """prefill_step(params, batch) -> the last position's logits.  Under a
    mesh context ``params`` are the rank's blocks (:func:`param_block`)
    and ``batch`` its rows."""
    def prefill_step(params, batch):
        on_mesh = current_mesh_context() is not None
        with sharded_params() if on_mesh else contextlib.nullcontext():
            out = model.forward(params, batch, last_logit_only=True)
        return out["logits"]

    return prefill_step


def make_serve_step(model: Transformer, mla_absorbed: bool = False, max_len: int = None):
    """serve_step(params, cache, tokens, pos) -> (logits, cache).

    Off a mesh the params and the cache are whole.  Under a mesh context
    every rank holds only its blocks: ``params`` under ``param_specs``
    (:func:`param_block`), ``cache`` under ``cache_shardings`` of the whole
    cache of ``max_len`` slots (:func:`cache_block`), and it returns its
    new cache blocks.  ``tokens`` (and an encoder's ``memory``, an input
    the step does not carry) come whole; a rank decodes its rows of them
    as ``batch_input_shardings`` places them (``pod``-major over the batch
    axes, where they divide the batch) and the logits are returned whole.
    """
    def serve_step(params, cache, tokens, pos, memory=None):
        ctx = current_mesh_context()
        if ctx is None:
            return model.decode_step(params, tokens, cache, pos, memory=memory,
                                     mla_absorbed=mla_absorbed)
        if max_len is None:
            raise ValueError("a serve step on a mesh needs the cache's max_len")
        mesh, B = ctx.mesh, int(tokens.shape[0])
        sizes = mesh_shape(mesh)
        bt = tuple(a for a in ("pod", "data") if a in sizes)
        nb = int(np.prod([sizes[a] for a in bt])) if bt else 1
        rows = bt if nb > 1 and B > 1 and B % nb == 0 else ()
        if rows:
            i = coll.axis_index(mesh, rows)
            tokens = tokens.chunk(nb, dim=0)[i]
            memory = memory.chunk(nb, dim=0)[i] if memory is not None else None
        with sharded_params(), row_axes(rows):
            logits, cache = model.decode_step(params, tokens, cache, pos, memory=memory,
                                              mla_absorbed=mla_absorbed,
                                              cache_specs=model.cache_specs(mesh, B, max_len))
        if rows:
            logits = coll.gather_leaf(logits, mesh, P(rows if len(rows) > 1 else rows[0]))
        return logits, cache

    return serve_step
