"""Parameter-tree utilities over nested dicts of tensors.

The port's parameter trees are plain nested ``dict``s whose leaves are
tensors, the counterpart of the JAX package's pytrees.  Leaves are visited
in **jax's order**: dict keys sorted, recursively, so the LSTM flattens as
``b, b_out, w_out, wh, wx`` and ``layer10`` sorts before ``layer2``.  The
AES ciphertext of an update depends on this order, so it is part of the
wire format.
"""

from __future__ import annotations

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


def flatten_to_vector(tree) -> Tuple[torch.Tensor, Callable]:
    """All leaves concatenated (jax order) into one 1-D fp32 vector.

    Returns ``(vector, unflatten_fn)``; the crypto layer serializes this
    vector as the transported update.
    """
    leaves = tree_leaves(tree)
    vec = torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])

    def unflatten(v):
        return unflatten_from_vector(v, tree)

    return vec, unflatten


def unflatten_from_vector(vec: torch.Tensor, like_tree):
    """Inverse of :func:`flatten_to_vector` given a template tree.  The
    leaves are views of ``vec`` where the dtype allows it."""
    out, offset = [], 0
    for l in tree_leaves(like_tree):
        size = int(l.numel())
        out.append(vec[offset:offset + size].reshape(l.shape).to(l.dtype))
        offset += size
    return tree_from_leaves(like_tree, out)


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
