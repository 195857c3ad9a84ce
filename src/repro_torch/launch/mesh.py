"""Production mesh construction (port of ``repro.launch.mesh``).

Single pod:  (16, 16)    axes ("data", "model")          = 256 ranks
Multi-pod:   (2, 16, 16) axes ("pod", "data", "model")   = 512 ranks

The ``pod`` axis is the EnFed cross-silo client axis for fsdp configs;
``data`` doubles as the client axis for everything else.

The reference builds a ``jax.sharding.Mesh`` over the devices of one
process.  The port runs one process per mesh rank: the ranks join one
``torch.distributed`` group, and each builds the same
``torch.distributed.device_mesh.DeviceMesh`` of the reference's shape and
axis names.  The group comes from ``torchrun``'s environment, from
:func:`spawn` (tests and ``chip_smoke.py``), or, for the dry run, from an
in-process fake group of 256 or 512 ranks
(``repro_torch.launch.dryrun``).

The mesh's device type is ``cpu``: its process groups are gloo on the
host, through which every collective stages its payload
(``repro_torch.sharding.collectives``).  Where a rank computes is its
model's device, the card unless the caller names another; what it holds
of the params and optimizer state in the train and prefill steps is its
block of each leaf under the reference's specs (``repro_torch.launch.
steps``), not a replica.

Mesh constructors are functions, so importing this module touches no
process group.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist


def _mesh(shape, axes):
    n = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices but only {have} present; the dry run "
            f"builds a fake process group of {n} ranks (repro_torch.launch.dryrun), "
            f"and a run spawns {n} ranks (repro_torch.launch.mesh.spawn, or torchrun)")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_debug_mesh(*, multi_pod: bool = False):
    """Small mesh for integration tests (needs 8 ranks)."""
    shape = (2, 2, 2) if multi_pod else (4, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def client_axes_for(cfg, mesh) -> tuple:
    """Which mesh axes act as the EnFed/FL client axes for this config.

    fsdp configs consume the data axis for ZeRO sharding, so they federate
    over the pod axis only (cross-silo); everything else federates over
    (pod,) data.  fsdp + MoE does not federate (the reference's token-local
    MoE dispatch inside a client region fails to partition): it trains as
    plain data parallel across pods, and the port keeps that.
    """
    from repro_torch.sharding.specs import axis_names

    names = axis_names(mesh)
    if getattr(cfg, "fsdp", False):
        if getattr(cfg, "moe", None) is not None:
            return ()
        return ("pod",) if "pod" in names else ()
    return tuple(a for a in ("pod", "data") if a in names)


# ---------------------------------------------------------------------------
# ranks on one host
# ---------------------------------------------------------------------------


def _rank_main(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        result = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(fn, world_size: int, *args):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` processes on
    this host, each with one torch thread and a joined gloo group (a
    ``file://`` rendezvous under a fresh temp dir, so concurrent runs never
    share a port).  Returns the ranks' return values in rank order (each
    passed back through ``torch.save``).  ``fn`` must be importable by name:
    the ranks are fresh interpreters.  ``fn`` and ``args`` reach the ranks
    through a file: a spawned process reads its arguments only once it has
    imported the caller's main module, so large arguments in the spawn
    call would start the ranks one after another.  A rank that raises makes
    this raise with its traceback."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        mp.spawn(_rank_main, args=(world_size, os.path.join(tmp, "init"), tmp),
                 nprocs=world_size, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
