"""Mesh context: activation sharding hints that do nothing without a mesh
(port of ``repro.sharding.ctx``).

Model code calls :func:`shard_activation(x, ("batch", None, "model"))`
with *logical* axis names.  When a mesh context is active (set by the
launcher or the dry run) the logical names are mapped to mesh axes; on a
run with no mesh the call returns ``x``.

Logical axes:
  "batch"  -> ("pod", "data") on the multi-pod mesh, ("data",) single-pod
  "model"  -> "model" (tensor-parallel: heads / d_ff / experts)
  "expert" -> "model" (expert-parallel shares the model axis)

The port runs one process per mesh rank.  Under :func:`sharded_params`
(the train, prefill and serve steps on a mesh) the params a rank is given
are its blocks under the reference's specs, and the layers compute split
over ``model`` where the reference's hints place them (heads or
``head_dim``, the SwiGLU hidden, the vocab, the experts:
:func:`model_split`), gathering any other leaf at use; outside it the
params are whole.  A hint on a plain tensor changes nothing; on a
``DTensor`` it redistributes to the resolved placements.

Beside the reference's ``manual`` axes (the client axes inside the
federated step), the context records ``rows``: the mesh axes over which
this rank's activation rows are a block of the step's global batch, major
first.  The MoE's token-local schedules read it to route exactly the
tokens the reference routes on each shard.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import NamedTuple, Optional, Tuple


from repro_torch.sharding.specs import P, axis_names, mesh_shape, to_placements

_STATE = threading.local()


class MeshContext:
    def __init__(self, mesh):
        self.mesh = mesh
        names = axis_names(mesh)
        if "pod" in names:
            self.batch_axes: Tuple[str, ...] = ("pod", "data")
        else:
            self.batch_axes = ("data",)
        self.model_axis = "model" if "model" in names else None
        self.manual: frozenset = frozenset()
        self.rows: Tuple[str, ...] = ()
        self.sharded = False

    def resolve(self, logical) -> P:
        """Map a tuple of logical axis names to a :class:`P`."""
        names = axis_names(self.mesh)
        out = []
        for ax in logical:
            if ax is None:
                out.append(None)
            elif ax == "batch":
                out.append(self.batch_axes if len(self.batch_axes) > 1 else self.batch_axes[0])
            elif ax in ("model", "expert"):
                out.append(self.model_axis)
            else:  # raw mesh axis name
                out.append(ax if ax in names else None)
        return P(*out)


def current_mesh_context() -> Optional[MeshContext]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = MeshContext(mesh) if mesh is not None else None
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def batch_axes() -> Tuple[str, ...]:
    ctx = current_mesh_context()
    return ctx.batch_axes if ctx is not None else ()


@contextlib.contextmanager
def manual_axes(axes):
    """Mark mesh axes as manual (the client axes of the federated step):
    sharding hints must not mention them, so ``shard_activation`` drops
    them while the context is active."""
    ctx = current_mesh_context()
    if ctx is None:
        yield
        return
    prev = ctx.manual
    ctx.manual = frozenset(axes)
    try:
        yield
    finally:
        ctx.manual = prev


@contextlib.contextmanager
def row_axes(axes):
    """Record that this rank's activation rows are its block of the global
    batch over ``axes`` (major first)."""
    ctx = current_mesh_context()
    if ctx is None:
        yield
        return
    prev = ctx.rows
    ctx.rows = tuple(axes)
    try:
        yield
    finally:
        ctx.rows = prev


@contextlib.contextmanager
def sharded_params():
    """Record that the params the model is given are this rank's blocks
    under the reference's specs (``repro_torch.sharding.specs``)."""
    ctx = current_mesh_context()
    if ctx is None:
        raise RuntimeError("sharded params need a mesh context (use_mesh)")
    prev = ctx.sharded
    ctx.sharded = True
    try:
        yield
    finally:
        ctx.sharded = prev


class ModelSplit(NamedTuple):
    """The ``model`` axis a layer computes split over: its mesh, size and
    this rank's index along it."""
    mesh: object
    n: int
    index: int


def model_split() -> Optional[ModelSplit]:
    """The ``model`` axis when the params are blocks
    (:func:`sharded_params`), the axis is larger than 1 and not manual;
    None otherwise (whole params: the layers compute unsplit)."""
    ctx = current_mesh_context()
    if ctx is None or not ctx.sharded or ctx.model_axis is None or "model" in ctx.manual:
        return None
    n = mesh_shape(ctx.mesh)["model"]
    if n == 1:
        return None
    names = axis_names(ctx.mesh)
    return ModelSplit(ctx.mesh, n, int(ctx.mesh.get_coordinate()[names.index("model")]))


def carried(fn):
    """``fn`` run under the calling thread's mesh context (a copy of it)
    on whatever thread calls it.  The state is thread-local, as the
    reference's; autograd recomputes a checkpointed block on the card's
    device thread, which would otherwise see no mesh."""
    ctx = current_mesh_context()
    if ctx is None:
        return fn
    saved = copy.copy(ctx)

    def run(*args, **kwargs):
        prev = getattr(_STATE, "ctx", None)
        _STATE.ctx = saved
        try:
            return fn(*args, **kwargs)
        finally:
            _STATE.ctx = prev

    return run


def pvary_manual(x):
    """The identity: the reference's mark of a value varying over the
    manual axes is a type of JAX's ``shard_map``, with no value."""
    return x


def shard_activation(x, logical):
    """``x`` redistributed to the logical sharding when it is a ``DTensor``
    and a mesh is active; ``x`` itself otherwise."""
    ctx = current_mesh_context()
    if ctx is None:
        return x
    spec = ctx.resolve(logical)
    if ctx.manual:
        # manual (client) axes are local to the rank: drop them
        def strip(entry):
            if entry is None:
                return None
            if isinstance(entry, tuple):
                kept = tuple(a for a in entry if a not in ctx.manual)
                return kept if len(kept) > 1 else (kept[0] if kept else None)
            return None if entry in ctx.manual else entry
        spec = P(*[strip(e) for e in spec])
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))
