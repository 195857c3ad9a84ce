"""Parameter and input sharding rules (port of ``repro.sharding.specs``).

``param_specs`` maps every parameter leaf to a :class:`P` (the port's
``PartitionSpec``) using the reference's path- and shape-based rules:

* leaves under a ``scan`` subtree have a leading stacked-layer axis that
  is never sharded;
* 3-D expert weights (``ffn/w{g,u,d}`` of a MoE block) put the expert
  axis on ``model`` (expert parallel);
* otherwise the last-most axis divisible by the ``model`` axis size is
  tensor-parallel, and the largest remaining axis divisible by the
  ``data`` axis size is FSDP-sharded (ZeRO-3 style);
* 1-D leaves (biases, norm scales, RG-LRU ``lam``) stay replicated.

Inputs shard their leading (batch) axis over ``("pod", "data")``.

The port keeps these specs as *placements*: the dry run reads per-device
bytes from them, and :func:`to_placements` turns one into DTensor
placements.  The train, prefill and serve steps run each rank on its full
local replica (the auto axes replicated); the numbers are the reference's
because GSPMD's partitioning changes no value.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions, or an :class:`AbstractMesh` (axis names and sizes, no
process group), which is all the rules read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


class P(tuple):
    """A partition spec: one entry per tensor axis, each ``None`` (not
    sharded), a mesh axis name, or a tuple of names (major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Mesh axis names and sizes with no devices behind them."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh or an :class:`AbstractMesh`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def _axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def _key_str(key) -> str:
    # jax's path keys: a dict key prints as itself, a NamedTuple field
    # (GetAttrKey) as ".field"
    return key if isinstance(key, str) else f".{key.name}"


class _Field:
    def __init__(self, name):
        self.name = name


def _path_str(path) -> str:
    return "/".join(_key_str(k) for k in path)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts and NamedTuples (the optimizer
    states), with jax's path keys."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f), path + (_Field(f),))
                            for f in tree._fields))
    return fn(path, tree)


def leaves_with_path(tree):
    """``(path string, leaf)`` of every leaf of nested dicts and NamedTuples
    (a :class:`P` is a leaf), in jax's order (dict keys sorted)."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f), path + (_Field(f),))
        else:
            out.append((_path_str(path), t))

    walk(tree, ())
    return out


def _spec_for(path: str, shape, mesh, fsdp: bool = True) -> P:
    ndim = len(shape)
    axes = [None] * ndim
    start = 1 if ("scan/" in path or path.startswith("encoder/")) and ndim >= 1 else 0
    model_n = _axis_size(mesh, "model")
    data_n = _axis_size(mesh, "data") if fsdp else 1
    eff = ndim - start
    if eff <= 1:
        return P(*axes)  # replicate 1-D leaves

    if path.rsplit("/", 1)[-1] == "embed" and eff == 2:
        # embedding tables shard only the vocab axis (Megatron-style), over
        # 'model' (and 'data' too when fsdp and still divisible)
        if model_n > 1 and shape[start] % model_n == 0:
            axes[start] = "model"
            if data_n > 1 and shape[start] % (model_n * data_n) == 0:
                axes[start] = ("data", "model")
        elif data_n > 1 and shape[start] % data_n == 0:
            axes[start] = "data"
        return P(*axes)

    if path.rsplit("/", 1)[-1] == "router":
        # the router enters the token-local MoE region replicated over 'data'
        if eff == 2 and model_n > 1 and shape[ndim - 1] % model_n == 0:
            axes[ndim - 1] = "model"
        return P(*axes)

    is_expert = "/ffn/" in path and path.rsplit("/", 1)[-1] in ("wg", "wu", "wd") and eff == 3
    if is_expert:
        # expert parallel over 'model' only; experts are never FSDP'd
        if shape[start] % model_n == 0:
            axes[start] = "model"
        return P(*axes)

    # tensor parallel: last-most divisible axis -> model
    tp_axis = None
    for i in range(ndim - 1, start - 1, -1):
        if model_n > 1 and shape[i] % model_n == 0:
            tp_axis = i
            axes[i] = "model"
            break
    # FSDP: largest remaining divisible axis -> data
    best, best_size = None, 0
    for i in range(start, ndim):
        if i != tp_axis and data_n > 1 and shape[i] % data_n == 0 and shape[i] > best_size:
            best, best_size = i, shape[i]
    if best is not None:
        axes[best] = "data"
    return P(*axes)


def param_specs(params, mesh, fsdp: bool = True):
    """A :class:`P` for every leaf of a parameter (or optimizer-state)
    tree.  ``fsdp=False`` keeps params replicated over the data axis
    (tensor parallel only), as the data axis doubles as the client axis."""
    # a host int leaf (the optimizer's step count) is a scalar
    return tree_map_with_path(
        lambda path, leaf: _spec_for(_path_str(path), tuple(getattr(leaf, "shape", ())), mesh,
                                     fsdp=fsdp),
        params)


def batch_spec(mesh) -> tuple:
    if "pod" in axis_names(mesh):
        return ("pod", "data")
    return ("data",)


def input_specs_sharding(batch, mesh):
    """Shard the leading axis of every input leaf over the batch axes."""
    b = batch_spec(mesh)
    spec_b = b if len(b) > 1 else b[0]

    def f(path, leaf):
        axes = [None] * len(leaf.shape)
        if len(axes) >= 1:
            axes[0] = spec_b
        return P(*axes)

    return tree_map_with_path(f, batch)


def replicated(mesh) -> P:
    return P()


def to_placements(spec: P, mesh):
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension
    ``Shard(i)`` if the spec puts that axis on tensor axis ``i``, else
    ``Replicate()``.  A tuple entry shards one tensor axis over several
    mesh axes, the first one major, as DTensor orders them by mesh
    dimension."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    where = {}
    for i, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
            if ax not in names:
                raise ValueError(f"spec {spec!r} names axis {ax!r}, not in the mesh {names}")
            if ax in where:
                raise ValueError(f"spec {spec!r} uses mesh axis {ax!r} twice")
            where[ax] = i
    for entry in spec:
        if isinstance(entry, tuple) and list(entry) != sorted(entry, key=names.index):
            raise ValueError(f"spec {spec!r}: a tuple entry must list mesh axes in mesh order")
    return [Shard(where[ax]) if ax in where else Replicate() for ax in names]


def shard_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The per-device block shape of a ``shape`` tensor under ``spec``
    (ceil division, as ``NamedSharding.shard_shape`` gives for the
    divisible cases the rules produce)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        n = 1
        for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
            n *= sizes[ax]
        out[i] = -(-out[i] // n)
    return tuple(out)
