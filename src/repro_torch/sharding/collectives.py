"""Collectives over the named axes of a device mesh, with a recorder.

The reference runs SPMD in one process and names its collectives inside
``shard_map`` (``psum``, ``all_gather``, ``ppermute``).  The port runs one
process per mesh rank and calls ``torch.distributed`` on the mesh's
per-axis process groups:

| reference   | here                                                       |
|-------------|------------------------------------------------------------|
| ``psum``    | :func:`all_reduce` (``dist.all_reduce``)                   |
| ``all_gather`` | :func:`all_gather` (one gather into a stacked tensor)   |
| ``ppermute`` ring hop | :func:`ppermute` (one ``dist.batch_isend_irecv``) |
| ``psum_scatter`` | :func:`reduce_scatter` (``dist.reduce_scatter_tensor``)  |

Several axes (the client axes ``("pod", "data")``) use the one group that
spans them, so a ``psum`` over both is one all-reduce.

Every call charges the active :class:`CollectiveRecorder` with its kind
(``all-reduce``, ``all-gather``, ``reduce-scatter``,
``collective-permute``) and its output bytes per device, as the reference's parse of the partitioned HLO counts
them (``repro.launch.hlo_stats.collective_bytes``).

Host staging.  Gloo is the one backend that runs several ranks on one card
(NCCL refuses two ranks on one device), and on the card's torch 2.11 its
TCP transport reads a CUDA tensor's memory as if it were the host's: an
all-reduce of one aborts the rank (``gloo::IoException ... writev: Bad
address``).  So every collective here stages a CUDA payload through host
memory, named by :func:`_staged`: only the payload crosses, and the
compute stays on the card.

A ``meta`` tensor (the dry run) carries no value: the fake process group
takes its all-reduces and all-gathers, and a ring hop of one is recorded
and not sent (point-to-point has no ``meta`` backend).

A leaf that the reference's spec shards is held as blocks
(``repro_torch.sharding.specs.leaf_block``): :func:`gather_leaf` puts a
leaf's blocks together over some of its axes, :func:`scatter_leaf` cuts a
whole leaf's gradient back to the block.

The autograd functions at the end are the differentiable forms the
layers' mesh schedules need.  The ranks of an axis over which the
activations are *replicated* (``model``; ``data`` where the rows are not
split) compute the same loss, so a value used on one rank only must have
its gradient summed over the axis, and a gathered value's gradient is
taken as is; the ranks of an axis that splits the rows (``data`` in a
data-parallel step) each hold a part of the objective, so a gathered
value's gradient is summed over it (:func:`gather`, ZeRO-3's
reduce-scatter).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding.specs import axis_names, entry_axes, mesh_shape

_RECORDERS: List["CollectiveRecorder"] = []   # process-wide: the card's backward
                                               # runs collectives on its own thread
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], object] = {}


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


class CollectiveRecorder:
    """The collectives called while it is active: ``(kind, bytes)`` per
    call, bytes being the output's per device."""

    def __init__(self):
        self.events: List[Tuple[str, int]] = []

    def charge(self, kind: str, nbytes: int) -> None:
        self.events.append((kind, int(nbytes)))

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for kind, _ in self.events:
            out[kind] = out.get(kind, 0) + 1
        return out


@contextlib.contextmanager
def record_collectives():
    """Charge every collective of the block to a fresh recorder (nested
    recorders each see the calls made inside them)."""
    rec = CollectiveRecorder()
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def _charge(kind: str, out: torch.Tensor) -> None:
    nbytes = out.numel() * out.element_size()
    for rec in _RECORDERS:
        rec.charge(kind, nbytes)


# ---------------------------------------------------------------------------
# groups and coordinates
# ---------------------------------------------------------------------------


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def coordinate(mesh) -> Dict[str, int]:
    """This rank's index along every mesh axis."""
    return dict(zip(axis_names(mesh), mesh.get_coordinate()))


def axis_index(mesh, axes) -> int:
    """This rank's row-major index over ``axes`` (the reference's
    ``_client_index``: ``idx * size(ax) + axis_index(ax)``)."""
    sizes, coord = mesh_shape(mesh), coordinate(mesh)
    idx = 0
    for ax in _axes(axes):
        idx = idx * sizes[ax] + coord[ax]
    return idx


def axes_size(mesh, axes) -> int:
    sizes = mesh_shape(mesh)
    n = 1
    for ax in _axes(axes):
        n *= sizes[ax]
    return n


def peer_rank(mesh, **index) -> int:
    """The global rank at this rank's coordinate with the named axes set
    to the given indices."""
    coord = coordinate(mesh)
    coord.update(index)
    return int(mesh.mesh[tuple(coord[a] for a in axis_names(mesh))])


def axis_group(mesh, axes):
    """The process group of the ranks that differ from this one only along
    ``axes``, ordered by :func:`axis_index`.  One axis is the mesh's own
    group; several are created once per mesh (every rank must ask for them
    in the same order, as every rank runs the same program)."""
    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = axis_names(mesh)
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in keep]
        ranks = mesh.mesh.permute(*rest, *keep).reshape(-1, axes_size(mesh, axes))
        group, _ = dist.new_subgroups_by_enumeration([r.tolist() for r in ranks])
        _GROUPS[key] = (mesh, group)   # the mesh is held so its id stays unique
    return _GROUPS[key][1]


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` must cross through host memory: a CUDA tensor on a
    gloo group (see the module's docstring)."""
    return x.device.type not in ("cpu", "meta") and dist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum of ``x`` over ``axes`` (a new tensor; ``x`` is not changed)."""
    group = axis_group(mesh, axes)
    staged = _staged(x, group)
    out = x.detach().cpu() if staged else x.detach().clone()
    dist.all_reduce(out, group=group)
    out = out.to(x.device) if staged else out
    _charge("all-reduce", out)
    return out


_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, stacked on a new leading axis in
    axis order."""
    n = axes_size(mesh, axis)
    group = axis_group(mesh, axis)
    staged = _staged(x, group)
    src = (x.detach().cpu() if staged else x.detach()).reshape(-1).contiguous()
    out = torch.empty((n * src.numel(),), dtype=x.dtype, device=src.device)
    _gather_single(out, src, group=group)
    out = out.reshape((n,) + tuple(x.shape))
    out = out.to(x.device) if staged else out
    _charge("all-gather", out)
    return out


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over ``axes``
    (``x``'s blocks in :func:`axis_index` order, ``axes`` in mesh order)."""
    n = axes_size(mesh, axes)
    group = axis_group(mesh, axes)
    staged = _staged(x, group)
    src = x.detach().movedim(dim, 0)
    src = (src.cpu() if staged else src).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"axis {dim} of {tuple(x.shape)} does not split over {axes} ({n})")
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=src.device)
    _scatter_single(out, src, group=group)
    out = out.movedim(0, dim).contiguous()
    out = out.to(x.device) if staged else out
    _charge("reduce-scatter", out)
    return out


def _gathered_axes(entry, axes) -> Tuple[str, ...]:
    return tuple(a for a in entry_axes(entry) if axes is None or a in axes)


def gather_leaf(x: torch.Tensor, mesh, spec, axes=None) -> torch.Tensor:
    """The blocks of a leaf put together over ``axes`` (every axis
    ``spec`` names by default): one all-gather per tensor axis that the
    spec shards over them.  Over part of a tuple entry, the result holds
    the blocks of the gathered axes at this rank's index of the others
    (``("data", "model")`` gathered over ``data``: blocks ``d * n_model +
    model`` for every ``d``)."""
    for i, entry in enumerate(spec):
        g = _gathered_axes(entry, axes)
        if g:
            shape = tuple(x.shape)
            x = all_gather(x.contiguous(), mesh, g).movedim(0, i)
            x = x.reshape(shape[:i] + (-1,) + shape[i + 1:])
    return x


def scatter_leaf(g: torch.Tensor, mesh, spec, axes=None, summed=()) -> torch.Tensor:
    """The inverse of :func:`gather_leaf` for a gradient: this rank's block
    of ``g``, summed over the gathered axes in ``summed`` (one
    reduce-scatter per tensor axis) and taken at this rank's index over
    the others."""
    sizes, coord = mesh_shape(mesh), coordinate(mesh)
    for i, entry in enumerate(spec):
        gathered = _gathered_axes(entry, axes)
        if not gathered:
            continue
        shape = list(g.shape)
        n = 1
        for a in gathered:
            n *= sizes[a]
        view = g.reshape(shape[:i] + [sizes[a] for a in gathered] + [shape[i] // n]
                         + shape[i + 1:])
        k, keep = i, []
        for a in gathered:
            if a in summed:
                keep.append(a)
                k += 1
            else:
                view = view.select(k, coord[a])
        view = view.reshape(shape[:i] + [-1] + shape[i + 1:])
        g = reduce_scatter(view, mesh, tuple(keep), dim=i) if keep else view.contiguous()
    return g


def ppermute(x: torch.Tensor, mesh, axis: str, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """One hop of ``perm`` (pairs ``(source, destination)`` of indices
    along ``axis``): this rank sends ``x`` to its destination and returns
    what its source sent.  A rank that receives nothing gets zeros, as
    ``ppermute`` gives."""
    me = axis_index(mesh, axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    out = torch.zeros_like(x)
    _charge("collective-permute", out)
    if x.device.type == "meta":
        return out
    group = axis_group(mesh, axis)
    staged = _staged(x, group)
    send = x.detach().cpu() if staged else x.detach().contiguous()
    recv = torch.empty_like(send)
    ops = []
    for d in dst:
        ops.append(dist.P2POp(dist.isend, send, peer_rank(mesh, **{axis: d}), group))
    for s in src:
        ops.append(dist.P2POp(dist.irecv, recv, peer_rank(mesh, **{axis: s}), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if src:
        out = recv.to(x.device) if staged else recv
    return out


# ---------------------------------------------------------------------------
# differentiable forms (activations replicated over an axis)
# ---------------------------------------------------------------------------


class _SumGrad(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward.  For
    a value replicated over the group that each rank uses on its own part
    of the work."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, ctx.axes), None, None


class _PartialSum(torch.autograd.Function):
    """Sum of the ranks' parts forward; every rank's part gets the
    (replicated) gradient as is backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Mean(torch.autograd.Function):
    """Mean over the group forward; backward each rank's term gets the
    gradient scaled by ``scale`` (``1/n`` when the ranks hold one
    replicated objective, 1 when each holds its part of a mean taken
    after)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, scale):
        ctx.scale = scale
        return all_reduce(x, mesh, axes) / axes_size(mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None, None


class _GatherRows(torch.autograd.Function):
    """The ranks' row blocks concatenated in axis order.  Backward: the
    gradient of this rank's block, summed over the group when every rank
    holds its own objective (``sum_grad``) or taken as is when the
    objective is replicated."""

    @staticmethod
    def forward(ctx, x, mesh, axis, sum_grad):
        ctx.mesh, ctx.axis, ctx.sum_grad = mesh, axis, sum_grad
        ctx.n, ctx.i = axes_size(mesh, axis), axis_index(mesh, axis)
        g = all_gather(x, mesh, axis)
        return g.reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = all_reduce(g.contiguous(), ctx.mesh, ctx.axis)
        return g.chunk(ctx.n, dim=0)[ctx.i].contiguous(), None, None, None


class _SliceRows(torch.autograd.Function):
    """This rank's block of rows of a replicated tensor; backward the
    blocks' gradients put back together over the group."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.n, ctx.i = axes_size(mesh, axis), axis_index(mesh, axis)
        return x.chunk(ctx.n, dim=0)[ctx.i].clone()

    @staticmethod
    def backward(ctx, g):
        full = torch.zeros((g.shape[0] * ctx.n,) + tuple(g.shape[1:]),
                           dtype=g.dtype, device=g.device)
        full.chunk(ctx.n, dim=0)[ctx.i].copy_(g)
        return all_reduce(full, ctx.mesh, ctx.axis), None, None


def sum_grad(x, mesh, axes):
    return _SumGrad.apply(x, mesh, axes)


def partial_sum(x, mesh, axes):
    return _PartialSum.apply(x, mesh, axes)


def mean(x, mesh, axes, replicated: bool):
    return _Mean.apply(x, mesh, axes, 1.0 / axes_size(mesh, axes) if replicated else 1.0)


def gather_rows(x, mesh, axis, sum_grad_: bool):
    return _GatherRows.apply(x, mesh, axis, sum_grad_)


def slice_rows(x, mesh, axis):
    return _SliceRows.apply(x, mesh, axis)


class _Gather(torch.autograd.Function):
    """:func:`gather_leaf` forward; :func:`scatter_leaf` backward."""

    @staticmethod
    def forward(ctx, x, mesh, spec, axes, summed):
        ctx.mesh, ctx.spec, ctx.axes, ctx.summed = mesh, spec, axes, summed
        return gather_leaf(x, mesh, spec, axes)

    @staticmethod
    def backward(ctx, g):
        return scatter_leaf(g.contiguous(), ctx.mesh, ctx.spec, ctx.axes, ctx.summed), \
            None, None, None, None


class _ScatterSum(torch.autograd.Function):
    """The sum over the spec's axes of the ranks' whole values, cut to this
    rank's block (a reduce-scatter) forward; the block's gradient gathered
    whole backward."""

    @staticmethod
    def forward(ctx, x, mesh, spec, axes):
        ctx.mesh, ctx.spec, ctx.axes = mesh, spec, axes
        every = tuple(a for entry in spec for a in _gathered_axes(entry, axes))
        return scatter_leaf(x.detach(), mesh, spec, axes, every)

    @staticmethod
    def backward(ctx, g):
        return gather_leaf(g, ctx.mesh, ctx.spec, ctx.axes), None, None, None


def gather(x, mesh, spec, axes=None, summed=()):
    """Differentiable :func:`gather_leaf`.  Its backward cuts the gradient
    to the block: summed over the axes in ``summed`` (those whose ranks
    each computed a part of the gradient: different rows, or a part of the
    work), taken as is over the others (ranks that computed the same
    gradient on the same rows)."""
    return _Gather.apply(x, mesh, spec, None if axes is None else tuple(axes), tuple(summed))


def scatter_sum(x, mesh, spec, axes=None):
    """Differentiable reduce-scatter: this rank's block under ``spec`` of
    the sum of the ranks' whole ``x`` over the spec's axes (``axes`` of
    them by default all)."""
    return _ScatterSum.apply(x, mesh, spec, None if axes is None else tuple(axes))
