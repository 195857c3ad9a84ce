"""Rank bodies of the port's mesh tests: each runs in one of
``repro_torch.launch.mesh.spawn``'s processes (torch and the port only, no
jax), computes on the CPU and returns numpy results to the test."""

import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core.topology import AggregationStrategy, aggregate_updates, gather_clients
from repro_torch.launch import mesh as tmesh, steps
from repro_torch.launch.hlo_stats import collective_bytes
from repro_torch.models import moe
from repro_torch.models.transformer import Transformer
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.ctx import use_mesh
from repro_torch.utils.tree import from_jax_params, tree_map, value_and_grad


def tree_items(tree, prefix=""):
    """``(path, numpy leaf)`` of a nested dict, keys sorted."""
    import numpy as np

    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _strategy(case, client_axes):
    return AggregationStrategy(kind=case["kind"], client_axes=client_axes,
                               neighborhood_size=case["k"], pod_local=case["pod_local"],
                               compress=case["compress"])


def aggregation(rank, world, data, device="cpu"):
    """Every aggregation case on both debug meshes: each client's own
    update through ``aggregate_updates``; the client-stacked results, the
    recorder's collective bytes and the counts ``CommDebugMode`` saw."""
    from torch.distributed.tensor.debug import CommDebugMode

    dev = torch.device(device)
    out = {}
    for multi in (False, True):
        mesh = tmesh.make_debug_mesh(multi_pod=multi)
        caxes = ("pod", "data") if multi else ("data",)
        c = coll.axis_index(mesh, caxes)
        coll.axis_group(mesh, caxes)            # groups made before any count
        for name, case in data["cases"].items():
            if case["multi"] != multi:
                continue
            u = {k: torch.from_numpy(v[c]).to(dev) for k, v in data["updates"].items()}
            mask = torch.from_numpy(data["masks"][case["mask"]]).to(dev)
            with CommDebugMode() as comm, coll.record_collectives() as rec:
                blk = aggregate_updates(u, mesh, _strategy(case, caxes), mask)
            full = gather_clients(blk, mesh, caxes)
            counts = {str(k): v for k, v in comm.get_comm_counts().items()}
            out[name] = dict(result=_np(full), bytes=collective_bytes(rec),
                             recorder=rec.counts(), comm=counts)
    return out if rank == 0 else None


def train_steps(rank, world, data, device="cpu"):
    """One federated train step of every strategy on (2, 2, 2) from the
    reference's weights; rank 0 returns the losses and the client-stacked
    params."""
    dev = torch.device(device)
    mesh = tmesh.make_debug_mesh(multi_pod=True)
    cfg = get_config(data["arch"])
    model = Transformer(cfg, device=dev)
    params = from_jax_params(data["params"], dev)
    batch = {k: torch.from_numpy(v).long().to(dev) for k, v in data["batch"].items()}
    caxes = tmesh.client_axes_for(cfg, mesh)
    C = steps.num_clients(mesh, caxes)
    out = {}
    for kind in data["kinds"]:
        strat = AggregationStrategy(kind=kind, client_axes=caxes, neighborhood_size=2)
        step, opt = steps.make_federated_train_step(model, mesh, strat, lr=data["lr"])
        mask = torch.from_numpy(data["mask"]).to(dev)
        if kind == "none":
            p2, _, loss = step(params, opt.init(params), batch, mask)
            full = p2
        else:
            pf = steps.client_block(steps.stack_for_clients(params, C), mesh, caxes)
            of = steps.client_block(steps.stack_for_clients(opt.init(params), C), mesh, caxes)
            p2, _, loss = step(pf, of, batch, mask)
            full = gather_clients(p2, mesh, caxes)
        out[kind] = dict(loss=float(loss), params=_np(full))
    return out if rank == 0 else None


def moe_schedules(rank, world, data, device="cpu"):
    """``moe_apply`` on a mesh (expert-parallel, token-local sort and
    einsum) on the same replicated tokens: the output, ``aux`` and the
    gradient of ``sum(y * r) + aux`` with respect to the params and the
    tokens, on every rank."""
    dev = torch.device(device)
    out = {}
    for multi in (False, True):
        mesh = tmesh.make_debug_mesh(multi_pod=multi)
        for dispatch in data["dispatches"]:
            cfg = get_config("debug-moe")
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
            params = from_jax_params(data["params"], dev)
            x = torch.from_numpy(data["x"]).to(dev)
            r = torch.from_numpy(data["r"]).to(dev)
            tree = {"p": params, "x": x}

            def f(t):
                y, aux = moe.moe_apply(t["p"], t["x"], cfg)
                return torch.sum(y * r) + aux

            with use_mesh(mesh):
                with torch.no_grad():
                    y, aux = moe.moe_apply(params, x, cfg)
                val, grads = value_and_grad(f, tree)
            out[(multi, dispatch)] = dict(y=y.numpy(), aux=float(aux), val=float(val),
                                          grads=_np(grads))
    return out


def agg_and_moe(rank, world, data):
    """The aggregation and MoE bodies in one set of ranks."""
    return dict(agg=aggregation(rank, world, data), moe=moe_schedules(rank, world, data["moe"]))


def run_with_reference(script: str, data, body):
    """Run the reference's ``script`` (reads the pickled ``data`` from
    argv[1], writes its results to argv[2]) in a subprocess of 8 fake host
    devices while ``body`` runs on 8 ranks of this host; returns (the
    reference's results, the ranks' results)."""
    import os
    import pickle
    import subprocess
    import sys
    import tempfile
    import textwrap
    from pathlib import Path

    from repro_torch.launch.mesh import spawn

    root = Path(__file__).resolve().parents[1]
    tmp = tempfile.mkdtemp(prefix="ref_mesh_")
    src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
    with open(src, "wb") as f:
        pickle.dump(data, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"))
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(script), src, dst],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = spawn(body, 8, data)
    finally:
        _, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    with open(dst, "rb") as f:
        return pickle.load(f), port
