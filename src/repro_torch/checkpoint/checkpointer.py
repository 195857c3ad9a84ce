"""Tree checkpointing to ``.npz`` (port of ``repro.checkpoint``).

Layout, as in the reference: ``<dir>/step_<8 digits>.npz`` holding the
flattened leaves, each keyed by its ``/``-joined path (a dict key, a
sequence index, or ``.field`` for a NamedTuple field, as ``jax``'s key
paths print).  The trees are the port's: dicts, tuples, lists and
NamedTuples whose leaves are tensors, numpy arrays or scalars; ``None`` is
an empty subtree.  Every leaf is saved as host numpy, and a restore returns
host numpy in the structure of a template tree, strict on each leaf's
shape and dtype (an fp32 buffer never restores into an int8 one); the
caller moves the leaves back to its device.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree):
    """``(key, child)`` pairs of an inner node, or None for a leaf; dict keys
    in sorted order, as jax visits them."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree, prefix=()):
    """``{path: host numpy leaf}`` of ``tree``."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {"/".join(prefix): _host(tree)}
    out = {}
    for key, child in kids:
        out.update(_flatten_with_paths(child, prefix + (key,)))
    return out


def _leaf_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _restore(template, data, prefix=()):
    """The template's structure with each leaf read from ``data``."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        key = "/".join(prefix)
        arr = data[key]
        if tuple(arr.shape) != tuple(np.shape(template)):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs template "
                             f"{tuple(np.shape(template))}")
        want = _leaf_dtype(template)
        if arr.dtype != want:
            # no silent cast: wire-format state restores as its resident dtype
            raise ValueError(f"dtype mismatch for {key}: ckpt {arr.dtype} vs template {want}")
        return arr
    vals = [_restore(child, data, prefix + (key,)) for key, child in kids]
    if isinstance(template, dict):
        return dict(zip(sorted(template), vals))
    if _is_namedtuple(template):
        return type(template)(*vals)
    return type(template)(vals)


def save_checkpoint(directory: str, step: int, state) -> str:
    """Write ``state`` as ``step_<N>.npz``, atomically: the tmp name ends in
    ``.npz`` (``np.savez`` adds no second suffix) and one ``os.replace``
    commits it, so a reader sees the old file or the new one, never a torn
    write."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten_with_paths(state))
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The newest step in ``directory`` (None when there is none); a
    ``*.tmp.npz`` left by a crash between the write and the rename is
    removed here and never counted."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for f in os.listdir(directory):
        if f.endswith(".tmp.npz"):
            try:
                os.remove(os.path.join(directory, f))
            except OSError:
                pass
            continue
        if m := re.match(r"step_(\d+)\.npz$", f):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, template, step: Optional[int] = None):
    """Restore into the structure of ``template`` (the newest step unless
    ``step`` names one).  Returns ``(state, step)``, every leaf host numpy."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with np.load(os.path.join(directory, f"step_{step:08d}.npz")) as data:
        return _restore(template, data), step
