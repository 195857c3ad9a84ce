"""Parameter-tree utilities over nested dicts of tensors.

The port's parameter trees are plain nested ``dict``s whose leaves are
tensors, the counterpart of the JAX package's pytrees.  Leaves are visited
in **jax's order**: dict keys sorted, recursively, so the LSTM flattens as
``b, b_out, w_out, wh, wx`` and ``layer10`` sorts before ``layer2``.  The
AES ciphertext of an update depends on this order, so it is part of the
wire format.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Tuple

import numpy as np
import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in jax order (sorted dict keys, depth first)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _rebuild(like, leaves_iter):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves_iter) for k in sorted(like)}
    return next(leaves_iter)


def tree_from_leaves(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in jax order)."""
    return _rebuild(like, iter(leaves))


def tree_size(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total byte footprint of a tree."""
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def tree_where(cond, a, b):
    """Leafwise ``torch.where(cond, a, b)``; ``cond`` is a scalar or
    indexes the leaves' leading axis."""
    cond = torch.as_tensor(cond)

    def _where(x, y):
        c = cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim())) if x.dim() > cond.dim() else cond
        return torch.where(c.to(x.device), x, y)

    return tree_map(_where, a, b)


def tree_weighted_mean(trees, weights):
    """``sum_i w_i * tree_i / sum_i w_i`` over a list of trees (eq. 14 in
    list form, plain torch)."""
    leaves0 = tree_leaves(trees[0])
    weights = torch.as_tensor(weights, dtype=torch.float32, device=leaves0[0].device)
    total = torch.sum(weights)

    def _avg(*leaves):
        stacked = torch.stack([l.to(torch.float32) for l in leaves])
        w = weights.reshape((-1,) + (1,) * (stacked.dim() - 1))
        return (torch.sum(stacked * w, dim=0) / total).to(leaves[0].dtype)

    return tree_map(_avg, *trees)


def tree_spec(tree, batch_ndim: int = 0):
    """A tree of ``(leaf_shape, dtype)`` past the first ``batch_ndim``
    axes: what :func:`tree_unravel` needs to rebuild ``tree``'s layout."""
    return tree_map(lambda l: (tuple(l.shape[batch_ndim:]), l.dtype), tree)


def tree_ravel(tree, batch_ndim: int = 0):
    """Ravel a (possibly batch-stacked) tree into one fp32 buffer.

    The first ``batch_ndim`` axes of every leaf are shared batch axes (the
    fleet's (R, N) requester x contributor grid); the rest of each leaf is
    concatenated, in jax leaf order, into a trailing parameter axis.
    Returns ``(flat, spec)``: ``flat`` of shape ``batch_shape + (P,)`` and
    ``spec`` (:func:`tree_spec`) for :func:`tree_unravel`.
    """
    leaves = tree_leaves(tree)
    batch = tuple(leaves[0].shape[:batch_ndim])
    flat = torch.cat([l.reshape(batch + (-1,)).to(torch.float32) for l in leaves],
                     dim=-1)
    return flat, tree_spec(tree, batch_ndim)


def tree_unravel(spec, flat: torch.Tensor):
    """Inverse of :func:`tree_ravel` for any leading batch shape.  The
    leaves are **views** of ``flat`` (for fp32 leaves), so autograd through
    them gives the gradient of ``flat`` directly, with no copy."""
    batch = tuple(flat.shape[:-1])
    out, off = [], 0
    for shape, dtype in tree_leaves(spec):
        size = int(np.prod(shape, dtype=np.int64))
        out.append(flat[..., off:off + size].reshape(batch + shape).to(dtype))
        off += size
    if off != flat.shape[-1]:
        raise ValueError(f"spec covers {off} parameters, the buffer holds "
                         f"{flat.shape[-1]}")
    return tree_from_leaves(spec, out)


def flatten_to_vector(tree) -> Tuple[torch.Tensor, Callable]:
    """All leaves concatenated (jax order) into one 1-D fp32 vector:
    :func:`tree_ravel` with no batch axis.

    Returns ``(vector, unflatten_fn)``; the crypto layer serializes this
    vector as the transported update.
    """
    vec, spec = tree_ravel(tree)
    return vec, functools.partial(tree_unravel, spec)


def unflatten_from_vector(vec: torch.Tensor, like_tree):
    """Inverse of :func:`flatten_to_vector` given a template tree.  The
    leaves are views of ``vec`` where the dtype allows it."""
    return tree_unravel(tree_spec(like_tree), vec)


def from_jax_params(np_tree, device) -> dict:
    """A tree of numpy arrays (the JAX package's params passed through
    ``np.asarray``) as a tree of tensors on ``device``.  Takes numpy only,
    so both packages can start from the same weights."""
    if isinstance(np_tree, dict):
        return {k: from_jax_params(v, device) for k, v in np_tree.items()}
    return torch.from_numpy(np.array(np_tree, copy=True)).to(device)


def to_numpy(tree):
    """A tree of tensors as a tree of numpy arrays (on the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def value_and_grad(fn: Callable, params):
    """``jax.value_and_grad(fn)(params)`` for a tree of tensors: the scalar
    ``fn(params)`` (detached) and its gradient with respect to every leaf,
    as a tree shaped like ``params``.  A leaf the value does not reach gets
    zeros, as jax gives it."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        value = fn(live)
    grads = torch.autograd.grad(value, tree_leaves(live), allow_unused=True,
                                materialize_grads=True)
    return value.detach(), tree_from_leaves(params, list(grads))
