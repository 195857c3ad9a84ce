"""Multi-pod dry run: run every (architecture x input shape) step on the
production meshes with no device, and record its work, its collectives
and its per-device argument bytes (port of ``repro.launch.dryrun``).

The reference lowers and compiles each step over 512 placeholder host
devices.  The port has no compiler to ask: it builds an in-process fake
process group of 256 or 512 ranks, takes rank 0's view of the mesh, puts
params, optimizer state, inputs and cache on the ``meta`` device, and
runs rank 0's step for real under three counters:

* ``torch.utils.flop_counter.FlopCounterMode`` — ``flops``;
* a byte counter (``_ByteCounter``) — ``bytes_accessed``, the sum of each
  aten op's input and output tensor bytes: an unfused upper bound;
* the collective recorder (``repro_torch.sharding.collectives``) — the
  collective keys, cross-checked against ``CommDebugMode``'s counts of
  all-reduces and all-gathers.

``argument_size_in_bytes`` is the per-device bytes of the step's arguments
under the reference's placements (``param_specs``, ``fed_param_shardings``,
``batch_input_shardings``, ``cache_shardings``).  The port runs the
``model`` axis (and ``data`` under fsdp) replicated, so each record also
gives ``executed_param_bytes_per_device`` (what rank 0 holds) and
``model_axis: "replicated"``: the placements are not what runs, and the
flops are rank 0's whole replica.  A mesh's failure is recorded as the
reference records it (``status: "error"`` with the traceback); a cached
record is skipped.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch debug-dense --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out build/dryrun
Options:
  --strategy {cfl,enfed,dfl_ring,dfl_mesh,none}   train aggregation schedule
  --neighborhood N                                EnFed nearby-device count
  --compress int8                                 int8 ring hops
  --mla-absorbed                                  absorbed MLA decode variant
  --moe-dispatch {sort,einsum,ep}                 MoE schedule
  --mlstm-chunk N                                 chunked mLSTM
  --out DIR                                       JSON output directory
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config, shape_supported
from repro_torch.core.topology import AggregationStrategy
from repro_torch.launch import inputs as inp
from repro_torch.launch.hlo_stats import collective_bytes
from repro_torch.launch.mesh import client_axes_for, make_production_mesh
from repro_torch.launch.steps import (fed_param_shardings, make_federated_train_step,
                                      make_prefill_step, make_serve_step, num_clients,
                                      stack_for_clients)
from repro_torch.models import Transformer
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.ctx import row_axes, use_mesh
from repro_torch.sharding.specs import (leaves_with_path, mesh_shape, param_specs, shard_shape,
                                        tree_map_with_path)

META = torch.device("meta")
BYTES_NOTE = "unfused upper bound: every aten op's input and output tensor bytes"


# ---------------------------------------------------------------------------
# the fake group and the counters
# ---------------------------------------------------------------------------


def _fake_group(n: int) -> None:
    """An in-process fake process group of ``n`` ranks, this process rank 0."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # an internal module of torch's: say so if it moved
        raise RuntimeError(
            "the dry run needs torch's in-process fake process group "
            "(torch.testing._internal.distributed.fake_pg.FakeStore), which this torch "
            f"({torch.__version__}) does not have") from e
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


class _ByteCounter(TorchDispatchMode):
    """Sums every aten op's input and output tensor bytes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten((args, kwargs or {}, out))[0]:
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def _arrays(tree):
    """Host int leaves (the optimizer's step count) as the reference's
    int32 scalars, so every argument has a shape and a dtype."""
    return tree_map_with_path(
        lambda _, x: x if isinstance(x, torch.Tensor)
        else torch.empty((), dtype=torch.int32, device=META), tree)


def _arg_bytes(tree, specs, mesh) -> int:
    total = 0
    for leaf, spec in zip(_leaves(tree), _leaves(specs)):
        total += int(np.prod(shard_shape(tuple(leaf.shape), spec, mesh), dtype=np.int64)) * \
            leaf.element_size()
    return total


def _leaves(tree):
    return [leaf for _, leaf in leaves_with_path(tree)]


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(_arrays(tree)))


# ---------------------------------------------------------------------------
# the steps on rank 0
# ---------------------------------------------------------------------------


def _batch_layout(mesh):
    sizes = mesh_shape(mesh)
    bt = tuple(a for a in ("pod", "data") if a in sizes)
    return bt, int(np.prod([sizes[a] for a in bt])) if bt else 1


def _rank_rows(tree, mesh, axis_of=lambda path: 0):
    """Rank 0's block of a batch-leading tree over the batch axes
    (``data``-major, as the plain data-parallel step lays it out), where
    ``batch_input_shardings`` would shard the leaf; the layout it used."""
    bt, nb = _batch_layout(mesh)
    layout = tuple(reversed(bt))
    split = False

    def f(path, x):
        nonlocal split
        ax = axis_of(path)
        if nb > 1 and x.dim() > ax and x.shape[ax] > 1 and x.shape[ax] % nb == 0:
            split = True
            return x.chunk(nb, dim=ax)[coll.axis_index(mesh, layout)]
        return x

    out = tree_map_with_path(f, tree)
    return out, (layout if split else ())


def lower_train(cfg, model, mesh, strategy_kind, neighborhood, compress=None):
    """Run rank 0's federated train step; returns (argument bytes, executed
    param bytes, number of clients)."""
    caxes = client_axes_for(cfg, mesh)
    C = num_clients(mesh, caxes)
    strategy = AggregationStrategy(kind=strategy_kind, client_axes=caxes,
                                   neighborhood_size=neighborhood, compress=compress)
    step, opt = make_federated_train_step(model, mesh, strategy, lr=1e-4)
    shp = INPUT_SHAPES["train_4k"]
    params = model.init(torch.Generator().manual_seed(0))
    opt_state = opt.init(params)
    batch = inp.train_inputs(cfg, shp["global_batch"], shp["seq_len"])
    mask = torch.ones((max(C, 1),), dtype=torch.float32, device=META)

    if not caxes or strategy_kind == "none":
        args_bytes = (_arg_bytes(params, param_specs(params, mesh, fsdp=cfg.fsdp), mesh)
                      + _arg_bytes(_arrays(opt_state),
                                   param_specs(_arrays(opt_state), mesh, fsdp=cfg.fsdp), mesh)
                      + _arg_bytes(batch, inp.batch_input_shardings(batch, mesh), mesh)
                      + mask.numel() * 4)
        step(params, opt_state, batch, mask)
        return args_bytes, _tree_bytes(params) + _tree_bytes(opt_state), C
    pf, of = stack_for_clients(params, C), stack_for_clients(_arrays(opt_state), C)
    args_bytes = (_arg_bytes(pf, fed_param_shardings(pf, mesh, caxes, cfg.fsdp), mesh)
                  + _arg_bytes(of, fed_param_shardings(of, mesh, caxes, cfg.fsdp), mesh)
                  + _arg_bytes(batch, inp.batch_input_shardings(
                      batch, mesh, client_stacked=True, client_axes=caxes), mesh)
                  + mask.numel() * 4)
    blk_p, blk_o = stack_for_clients(params, 1), stack_for_clients(opt_state, 1)
    step(blk_p, blk_o, batch, mask)
    return args_bytes, _tree_bytes(blk_p) + _tree_bytes(blk_o), C


def lower_prefill(cfg, model, mesh, shape_name):
    shp = INPUT_SHAPES[shape_name]
    step = make_prefill_step(model)
    params = model.init(torch.Generator().manual_seed(0))
    batch = inp.prefill_inputs(cfg, shp["global_batch"], shp["seq_len"])
    args_bytes = (_arg_bytes(params, param_specs(params, mesh, fsdp=cfg.fsdp), mesh)
                  + _arg_bytes(batch, inp.batch_input_shardings(batch, mesh), mesh))
    local, layout = _rank_rows(batch, mesh)
    with torch.no_grad(), row_axes(layout):
        step(params, local)
    return args_bytes, _tree_bytes(params)


def lower_decode(cfg, model, mesh, shape_name, mla_absorbed=False):
    shp = INPUT_SHAPES[shape_name]
    B, S = shp["global_batch"], shp["seq_len"]
    step = make_serve_step(model, mla_absorbed=mla_absorbed)
    params = model.init(torch.Generator().manual_seed(0))
    cache = inp.cache_shapes(model, B, S)
    tokens = inp.decode_inputs(cfg, B)["tokens"]
    memory = inp.decode_memory(cfg, B, S)
    args_bytes = (_arg_bytes(params, param_specs(params, mesh, fsdp=cfg.fsdp), mesh)
                  + _arg_bytes(cache, inp.cache_shardings(cache, mesh), mesh)
                  + _arg_bytes({"tokens": tokens},
                               inp.batch_input_shardings({"tokens": tokens}, mesh), mesh)
                  + 4)                                           # pos, an int32 scalar
    if memory is not None:
        args_bytes += _arg_bytes({"m": memory}, inp.cache_shardings({"m": memory}, mesh), mesh)
    local_tokens, layout = _rank_rows(tokens, mesh)
    if layout:
        local_cache, _ = _rank_rows(cache, mesh,
                                    axis_of=lambda path: 1 if "scan" in path else 0)
        local_memory = _rank_rows(memory, mesh)[0] if memory is not None else None
    else:
        local_cache, local_memory = cache, memory
    with torch.no_grad(), row_axes(layout):
        step(params, local_cache, local_tokens, S - 1, memory=local_memory)
    return args_bytes, _tree_bytes(params)


def run_one(arch: str, shape_name: str, multi_pod: bool, strategy: str = "cfl",
            neighborhood: int = 4, mla_absorbed: bool = False,
            moe_dispatch: str = None, mlstm_chunk: int = 0,
            compress: str = None) -> dict:
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_config(arch)
    if moe_dispatch and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=moe_dispatch))
    if mlstm_chunk:
        cfg = cfg.replace(mlstm_chunk=mlstm_chunk)
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
           "strategy": strategy, "status": "skipped", "mla_absorbed": mla_absorbed,
           "moe_dispatch": moe_dispatch, "mlstm_chunk": mlstm_chunk,
           "compress": compress}
    if not shape_supported(cfg, shape_name):
        rec["reason"] = "full-attention arch: long_500k decode skipped"
        return rec
    _fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    model = Transformer(cfg, device=META)
    kind = INPUT_SHAPES[shape_name]["kind"]
    flops, nbytes = FlopCounterMode(display=False), _ByteCounter()
    t0 = time.time()
    with use_mesh(mesh), CommDebugMode() as comm, coll.record_collectives() as recorder:
        with flops, nbytes:
            if kind == "train":
                args_bytes, executed, C = lower_train(cfg, model, mesh, strategy, neighborhood,
                                                      compress=compress)
                rec["num_clients"] = C
            elif kind == "prefill":
                args_bytes, executed = lower_prefill(cfg, model, mesh, shape_name)
            else:
                args_bytes, executed = lower_decode(cfg, model, mesh, shape_name, mla_absorbed)
    rec["run_s"] = round(time.time() - t0, 3)
    rec["flops"] = float(flops.get_total_flops())
    rec["bytes_accessed"] = float(nbytes.bytes)
    rec["bytes_accessed_note"] = BYTES_NOTE
    rec.update(collective_bytes(recorder))
    counts = {str(k): int(v) for k, v in comm.get_comm_counts().items()}
    rec["comm_debug_counts"] = counts
    seen = recorder.counts()
    for kind_, op in (("all-reduce", "c10d.allreduce_"), ("all-gather", "c10d._allgather_base_")):
        if seen.get(kind_, 0) != counts.get(op, 0):
            raise RuntimeError(f"the recorder saw {seen.get(kind_, 0)} {kind_}s, "
                               f"CommDebugMode {counts.get(op, 0)}")
    rec["argument_size_in_bytes"] = float(args_bytes)
    rec["executed_param_bytes_per_device"] = float(executed)
    rec["model_axis"] = "replicated"
    rec["n_devices"] = int(np.prod(list(mesh_shape(mesh).values())))
    rec["status"] = "ok"
    return rec


def record_tag(arch, shape, multi_pod, strategy, mla_absorbed=False, moe_dispatch=None,
               mlstm_chunk=0, compress=None) -> str:
    tag = f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}__{strategy}"
    if mla_absorbed:
        tag += "__absorbed"
    if moe_dispatch:
        tag += f"__{moe_dispatch}"
    if mlstm_chunk:
        tag += f"__chunk{mlstm_chunk}"
    if compress:
        tag += f"__{compress}"
    return tag


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--strategy", default="cfl",
                    choices=("cfl", "enfed", "dfl_ring", "dfl_mesh", "none"))
    ap.add_argument("--neighborhood", type=int, default=4)
    ap.add_argument("--compress", default=None, choices=(None, "int8"))
    ap.add_argument("--mla-absorbed", action="store_true")
    ap.add_argument("--moe-dispatch", default=None, choices=(None, "sort", "einsum", "ep"))
    ap.add_argument("--mlstm-chunk", type=int, default=0)
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = sorted(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = sorted(INPUT_SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_fail = 0
    try:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    tag = record_tag(arch, shape, mp, args.strategy, args.mla_absorbed,
                                     args.moe_dispatch, args.mlstm_chunk, args.compress)
                    path = os.path.join(args.out, tag + ".json")
                    if os.path.exists(path):
                        print(f"[skip cached] {tag}")
                        continue
                    print(f"[dryrun] {tag} ...", flush=True)
                    try:
                        rec = run_one(arch, shape, mp, args.strategy, args.neighborhood,
                                      args.mla_absorbed, args.moe_dispatch, args.mlstm_chunk,
                                      args.compress)
                    except Exception as e:
                        rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                               "strategy": args.strategy, "status": "error",
                               "error": f"{type(e).__name__}: {e}",
                               "traceback": traceback.format_exc()[-2000:]}
                        n_fail += 1
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=2)
                    msg = rec["status"]
                    if rec["status"] == "ok":
                        msg += (f" flops/dev={rec.get('flops', 0):.3e}"
                                f" coll={rec.get('total_collective_bytes', 0):.3e}B"
                                f" args={rec.get('argument_size_in_bytes', 0) / 2**30:.2f}GiB"
                                f" run={rec.get('run_s')}s")
                    print(f"[dryrun] {tag}: {msg}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"done ({n_fail} failures)")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
