"""Rank bodies of the port's mesh tests: each runs in one of
``repro_torch.launch.mesh.spawn``'s processes (torch and the port only, no
jax), computes on the CPU and returns numpy results to the test."""

import contextlib
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core.topology import AggregationStrategy, aggregate_updates, gather_clients
from repro_torch.launch import mesh as tmesh, steps
from repro_torch.launch.hlo_stats import collective_bytes
from repro_torch.models import moe
from repro_torch.models.transformer import Transformer
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.ctx import model_split, sharded_params, use_mesh
from repro_torch.sharding.specs import _spec_for, leaves_with_path, param_specs, tree_block
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


def _batch(batch, dev):
    """A numpy batch as tensors on ``dev``: token ids int64, frames as
    they are."""
    import numpy as np

    return {k: (torch.from_numpy(v).long() if np.issubdtype(v.dtype, np.integer)
                else torch.from_numpy(v)).to(dev) for k, v in batch.items()}


def _held_bytes(*trees) -> int:
    return sum(x.numel() * x.element_size() for t in trees for _, x in leaves_with_path(t)
               if isinstance(x, torch.Tensor))


def sharded_step(rank, params, case, lr, batch, device="cpu"):
    """One federated train step of ``case`` (arch, fsdp, the mesh: multi-pod
    or a ``shape``, kind) from whole ``params`` (numpy): the rank's blocks
    in and out.  Returns
    the loss, the rank's new param blocks, the shapes of its Adam blocks
    and the bytes of the blocks it held going in."""
    dev = torch.device(device)
    mesh = case_mesh(case)
    cfg = case_config(case)
    if case["fsdp"]:
        cfg = cfg.replace(fsdp=True)
    model = Transformer(cfg, device=dev)
    whole = from_jax_params(params, dev)
    batch = _batch(batch, dev)
    caxes = tmesh.client_axes_for(cfg, mesh)
    C = steps.num_clients(mesh, caxes)
    strat = AggregationStrategy(kind=case["kind"], client_axes=caxes, neighborhood_size=2)
    step, opt = steps.make_federated_train_step(model, mesh, strat, lr=lr)
    mask = torch.ones(max(C, 1), dtype=torch.float32, device=dev)
    if case["kind"] == "none" or not caxes:
        specs = param_specs(whole, mesh, fsdp=cfg.fsdp)
        pb = steps.param_block(whole, mesh, cfg.fsdp)
        ob = steps.param_block(opt.init(whole), mesh, cfg.fsdp)
    else:
        stacked = steps.stack_for_clients(whole, C)
        specs = steps.fed_param_shardings(stacked, mesh, caxes, cfg.fsdp)
        pb = steps.client_block(stacked, mesh, caxes, cfg.fsdp)
        ob = steps.client_block(steps.stack_for_clients(opt.init(whole), C), mesh, caxes,
                                cfg.fsdp)
        del stacked
    held = _held_bytes(pb, ob)
    del whole
    with coll.record_collectives() as rec:
        p2, o2, loss = step(pb, ob, batch, mask)
    return dict(loss=float(loss), blocks=_np(p2), held=held, collectives=rec.events,
                specs={"/" + k: tuple(v) for k, v in leaves_with_path(specs)},
                adam={name: {k: v.shape for k, v in tree_items(getattr(o2, name))}
                      for name in ("mu", "nu")})


def sharded_steps(rank, world, data, device="cpu"):
    """:func:`sharded_step` of every case of ``data["cases"]``, each from
    its preset's weights in ``data["params"]``."""
    return {name: sharded_step(rank, data["params"][case["arch"]], case, data["lr"],
                               data["batch"], device)
            for name, case in data["cases"].items()}


def train_steps(rank, world, data, device="cpu"):
    """One federated train step of every strategy on (2, 2, 2) from the
    reference's weights; every rank returns the losses, its param blocks
    and the params gathered whole (client-stacked, except ``"none"``)."""
    dev = torch.device(device)
    cfg = get_config(data["arch"])
    model = Transformer(cfg, device=dev)
    mesh = tmesh.make_debug_mesh(multi_pod=True)
    caxes = tmesh.client_axes_for(cfg, mesh)
    out = {}
    for kind in data["kinds"]:
        case = dict(arch=data["arch"], fsdp=False, multi=True, kind=kind)
        res = sharded_step(rank, data["params"], case, data["lr"], data["batch"], device)
        blocks = from_jax_params(res["blocks"], dev)
        full = steps.gather_params(blocks, model, mesh, () if kind == "none" else caxes)
        out[kind] = dict(res, params=_np(full))
    return out


def _moe_specs(params, mesh):
    """The specs of a MoE block's ``ffn`` leaves (as the model's tree
    places them: the expert rule needs the ``/ffn/`` path)."""
    return {k: _spec_for(f"tail0_attn/ffn/{k}", tuple(v.shape), mesh, fsdp=False)
            for k, v in params.items()}


def moe_schedules(rank, world, data, device="cpu"):
    """``moe_apply`` on a mesh (expert-parallel, token-local sort and
    einsum) on the same replicated tokens: the output, ``aux`` and the
    gradient of ``sum(y * r) + aux`` with respect to the params and the
    tokens, on every rank.  Once with whole params (``"whole"``, as the
    serve step runs), once with the rank's blocks under their specs
    (``"sharded"``, as the train and prefill steps run; the gradients of
    the blocks gathered whole)."""
    dev = torch.device(device)
    out = {}
    for multi in (False, True):
        mesh = tmesh.make_debug_mesh(multi_pod=multi)
        for dispatch in data["dispatches"]:
            for layout in ("whole", "sharded"):
                cfg = get_config("debug-moe")
                cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
                params = from_jax_params(data["params"], dev)
                specs = _moe_specs(params, mesh)
                if layout == "sharded":
                    params = tree_block(params, specs, mesh, coll.coordinate(mesh))
                x = torch.from_numpy(data["x"]).to(dev)
                r = torch.from_numpy(data["r"]).to(dev)
                tree = {"p": params, "x": x}
                with use_mesh(mesh), (sharded_params() if layout == "sharded"
                                      else contextlib.nullcontext()):
                    tp = model_split()

                    def f(t):
                        y, aux = moe.moe_apply(t["p"], t["x"], cfg, tp=tp)
                        return torch.sum(y * r) + aux

                    with torch.no_grad():
                        y, aux = moe.moe_apply(params, x, cfg, tp=tp)
                    val, grads = value_and_grad(f, tree)
                if layout == "sharded":
                    grads = dict(grads, p={k: coll.gather_leaf(v, mesh, specs[k])
                                           for k, v in grads["p"].items()})
                out[(multi, dispatch, layout)] = dict(y=y.numpy(), aux=float(aux),
                                                      val=float(val), grads=_np(grads))
    return out


def leaf_collectives(rank, world, data):
    """``coll.gather`` and ``coll.scatter_sum`` of each case of
    ``data["leaf_cases"]`` (mesh, spec, axes, summed, kind) on this rank's
    block of the leaf (gather) or this rank's whole value (scatter_sum):
    the value, the gradient of ``sum(value * weights[rank])`` and the
    recorder's events of the forward and the backward."""
    from repro_torch.sharding.specs import P, leaf_block

    out = {}
    for name, case in data["leaf_cases"].items():
        mesh = tmesh.make_debug_mesh(multi_pod=case["multi"])
        spec = P(*case["spec"])
        coord = coll.coordinate(mesh)
        if case["kind"] == "gather":
            x = leaf_block(torch.from_numpy(data["leaf"]), spec, mesh, coord)
        else:
            x = torch.from_numpy(data["values"][rank])
        x.requires_grad_(True)
        with coll.record_collectives() as fwd:
            if case["kind"] == "gather":
                y = coll.gather(x, mesh, spec, axes=case["axes"], summed=case["summed"])
            else:
                y = coll.scatter_sum(x, mesh, spec)
        w = torch.from_numpy(data["weights"][rank][tuple(slice(0, n) for n in y.shape)])
        with coll.record_collectives() as bwd:
            (g,) = torch.autograd.grad(torch.sum(y * w), x)
        out[name] = dict(value=y.detach().numpy(), grad=g.numpy(), fwd=fwd.events,
                         bwd=bwd.events, coord=coord)
    return out


def agg_and_moe(rank, world, data):
    """The aggregation, MoE and leaf-collective bodies in one set of ranks."""
    return dict(agg=aggregation(rank, world, data), moe=moe_schedules(rank, world, data["moe"]),
                leaf=leaf_collectives(rank, world, data))


def run_with_reference(script: str, data, body, port_data=None):
    """Run the reference's ``script`` (reads the pickled ``data`` from
    argv[1], writes its results to argv[2]) in a subprocess of 8 fake host
    devices while ``body`` runs on 8 ranks of this host (on ``port_data``
    where given, else ``data``); returns (the reference's results, the
    ranks' results)."""
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
        port = spawn(body, 8, data if port_data is None else port_data)
    finally:
        _, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    with open(dst, "rb") as f:
        return pickle.load(f), port


def case_mesh(case):
    """The mesh of a case: ``make_debug_mesh`` (``multi``) or a
    ``("data", "model")`` mesh of ``shape``."""
    if "shape" in case:
        return tmesh._mesh(tuple(case["shape"]), ("data", "model"))
    return tmesh.make_debug_mesh(multi_pod=case["multi"])


def case_config(case):
    """A registered preset by name, or a config from its fields (an MLA
    config as a dict of its own fields)."""
    from repro_torch.models.config import MLAConfig, ModelConfig

    if "arch" in case:
        return get_config(case["arch"])
    fields = dict(case["fields"])
    if isinstance(fields.get("mla"), dict):
        fields["mla"] = MLAConfig(**fields["mla"])
    return ModelConfig(**fields)


def sharded_decode(rank, case, params, tokens, device="cpu", memory=None):
    """The serve step of ``case`` on this rank's blocks: ``tokens`` (B, T)
    fed one a step at ``case["positions"]`` (by default 0 ... T-1) into a
    cache of ``case["max_len"]`` slots (the prompt prefilled by sequential
    decode, as ``repro_torch.launch.serve`` does, then the decode steps).
    Returns the whole logits of every step, the rank's cache blocks after
    the last, the bytes of the param and cache blocks it held going in and
    the keys of every decode state gathered at use (an encoder-decoder's
    ``memory`` (B, T, D) comes whole, as the serve step takes it)."""
    from repro_torch.models import transformer
    from repro_torch.sharding.ctx import use_mesh as _use_mesh

    dev = torch.device(device)
    mesh = case_mesh(case)
    cfg = case_config(case)
    model = Transformer(cfg, device=dev)
    whole = from_jax_params(params, torch.device("cpu"))
    B, L = tokens.shape[0], case["max_len"]
    pb = tree_map(lambda t: t.to(dev), steps.param_block(whole, mesh, cfg.fsdp))
    cache = tree_map(lambda t: t.to(dev),
                     steps.cache_block(Transformer(cfg, device="cpu").init_cache(B, L), mesh))
    held = _held_bytes(pb, cache)
    del whole
    toks = torch.from_numpy(tokens).long().to(dev)
    step = steps.make_serve_step(model, max_len=L)
    mem = torch.from_numpy(memory).to(dev) if memory is not None else None
    logits, gathered = [], []
    state_use = transformer._state_use

    def recording_state_use(state, specs):
        gathered.append(tuple(sorted(state)))
        return state_use(state, specs)

    transformer._state_use = recording_state_use
    try:
        with _use_mesh(mesh), torch.no_grad():
            for t, pos in enumerate(case.get("positions", range(toks.shape[1]))):
                lg, cache = step(pb, cache, toks[:, t:t + 1], pos, memory=mem)
                logits.append(lg.cpu().numpy())
    finally:
        transformer._state_use = state_use
    return dict(logits=logits, cache=_np(cache), held=held, gathered=sorted(set(gathered)))


def sharded_prefill(rank, case, params, tokens, device="cpu"):
    """The prefill step of ``case`` on this rank's param blocks and its
    rows of ``tokens`` over ``data``; the last position's logits gathered
    whole."""
    from repro_torch.sharding.ctx import row_axes, use_mesh as _use_mesh
    from repro_torch.sharding.specs import P

    dev = torch.device(device)
    mesh = case_mesh(case)
    cfg = case_config(case)
    model = Transformer(cfg, device=dev)
    pb = steps.param_block(from_jax_params(params, dev), mesh, cfg.fsdp)
    rows = torch.from_numpy(tokens).long().to(dev).chunk(
        coll.axes_size(mesh, "data"), dim=0)[coll.axis_index(mesh, "data")]
    with _use_mesh(mesh), torch.no_grad(), row_axes(("data",)):
        logits = steps.make_prefill_step(model)(pb, {"tokens": rows})
        logits = coll.gather_leaf(logits, mesh, P("data"))
    return logits.cpu().numpy()


def sharded_grads(rank, case, params, batch):
    """The gradient of ``lm_loss`` on this rank's param blocks (the whole
    batch on every rank), gathered whole; and, on rank 0, the same
    gradient on one device."""
    from repro_torch.sharding.ctx import use_mesh as _use_mesh
    from repro_torch.sharding.specs import map_with_specs

    mesh = case_mesh(case)
    cfg = case_config(case).replace(fsdp=case.get("fsdp", False))
    model = Transformer(cfg, device="cpu")
    whole = from_jax_params(params, torch.device("cpu"))
    batch = _batch(batch, torch.device("cpu"))
    with _use_mesh(mesh), sharded_params():
        _, g = value_and_grad(lambda p: steps.lm_loss(model, p, batch),
                              steps.param_block(whole, mesh, cfg.fsdp))
    out = dict(sharded=_np(map_with_specs(lambda x, s: coll.gather_leaf(x, mesh, s), g,
                                          model.param_specs(mesh))))
    if rank == 0:
        out["one_device"] = _np(value_and_grad(lambda p: steps.lm_loss(model, p, batch),
                                               whole)[1])
    return out


def decode_cases(rank, world, data):
    """Every decode case of ``data["decode"]``, the prefill cases of
    ``data["prefill"]``, the train steps of ``data["train"]`` and the
    gradients of ``data["grads"]``."""
    out = {"decode": {}, "prefill": {}, "train": {}, "grads": {}}
    for name, case in data["decode"].items():
        out["decode"][name] = sharded_decode(rank, case, data["params"][case["params"]],
                                             data["tokens"][name])
    for name, case in data["prefill"].items():
        out["prefill"][name] = sharded_prefill(rank, case, data["params"][case["params"]],
                                               data["tokens"][name])
    for name, case in data["train"].items():
        out["train"][name] = sharded_step(rank, data["params"][case["params"]], case,
                                          data["lr"], data["batch"])
    for name, case in data["grads"].items():
        out["grads"][name] = sharded_grads(rank, case, data["params"][case["params"]],
                                           data["batch"])
    return out


def variant_cases(rank, world, data):
    """The mixer variants' cases of ``data``: a train step of every case of
    ``data["train"]`` (its own batch), the serve steps of
    ``data["decode"]`` (an encoder-decoder's with its ``memory``) and the
    gradients of ``data["grads"]``."""
    out = {"train": {}, "decode": {}, "grads": {}}
    for name, case in data["train"].items():
        out["train"][name] = sharded_step(rank, data["params"][case["params"]], case,
                                          data["lr"], data["batches"][name])
    for name, case in data["decode"].items():
        out["decode"][name] = sharded_decode(rank, case, data["params"][case["params"]],
                                             data["tokens"][name],
                                             memory=data["memory"].get(name))
    for name, case in data["grads"].items():
        out["grads"][name] = sharded_grads(rank, case, data["params"][case["params"]],
                                           data["batches"][case["batch"]])
    return out
