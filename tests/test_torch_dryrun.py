"""The port's dry run on an in-process fake process group (256 or 512
ranks, no device) against the reference's rules: for both presets, the
four input shapes, both production meshes and the ``cfl`` and ``enfed``
schedules, the record's status and skips are the reference's
``shape_supported``; ``num_clients`` and ``n_devices`` are the reference's;
``argument_size_in_bytes`` is the sum over the step's arguments of the
per-device block bytes that the reference's specs give on a
``jax.sharding.AbstractMesh`` (token ids counted at the port's int64);
the records round-trip through ``repro_torch.launch.roofline``.  Also the
CLI's file tags and skip-cached behaviour, and why the roofline's scan
correction is 1: the port's flop counter runs every layer."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch import inputs as jinputs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
ARCHS = ("debug-dense", "debug-moe")
STRATEGIES = ("cfl", "enfed")
TOKEN_KEYS = ("tokens", "labels")


@pytest.fixture(scope="module")
def records():
    """Every record once (the inference shapes do not depend on the
    schedule, so their record is run once and relabelled)."""
    import torch.distributed as dist

    out = {}
    try:
        for arch in ARCHS:
            for shape in SHAPES:
                for mp in (False, True):
                    for strat in STRATEGIES:
                        key = (arch, shape, mp, "cfl")
                        if strat == "cfl" or shape == "train_4k":
                            out[(arch, shape, mp, strat)] = dryrun.run_one(arch, shape, mp, strat)
                        else:
                            out[(arch, shape, mp, strat)] = dict(out[key], strategy=strat)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


def _amesh(mp):
    return AbstractMesh((2, 16, 16), ("pod", "data", "model")) if mp else \
        AbstractMesh((16, 16), ("data", "model"))


def _bytes(tree, shardings, int64_keys=()):
    total = 0
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    shs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    for (path, leaf), sh in zip(flat, shs):
        item = 8 if jspecs._path_str(path).split("/")[-1] in int64_keys else \
            np.dtype(leaf.dtype).itemsize
        total += int(np.prod(sh.shard_shape(leaf.shape), dtype=np.int64)) * item
    return total


def _ref_argument_bytes(arch, shape, mp, strategy):
    cfg = jconfigs.get_config(arch)
    model = JTransformer(cfg)
    mesh = _amesh(mp)
    shp = jconfigs.INPUT_SHAPES[shape]
    B, S = shp["global_batch"], shp["seq_len"]
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    psh = jspecs.param_specs(params, mesh, fsdp=cfg.fsdp)
    if shp["kind"] == "train":
        caxes = jmesh.client_axes_for(cfg, mesh)
        C = jsteps.num_clients(mesh, caxes)
        opt = jax.eval_shape(jadam(1e-4).init, params)
        batch = jinputs.train_inputs(cfg, B, S)
        stack = lambda t: jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct((C,) + x.shape, x.dtype), t)
        pf, of = stack(params), stack(opt)
        return (_bytes(pf, jsteps.fed_param_shardings(pf, mesh, caxes, cfg.fsdp))
                + _bytes(of, jsteps.fed_param_shardings(of, mesh, caxes, cfg.fsdp))
                + _bytes(batch, jinputs.batch_input_shardings(
                    batch, mesh, client_stacked=True, client_axes=caxes), TOKEN_KEYS)
                + 4 * C), C
    if shp["kind"] == "prefill":
        batch = jinputs.prefill_inputs(cfg, B, S)
        return _bytes(params, psh) + _bytes(batch, jinputs.batch_input_shardings(
            batch, mesh), TOKEN_KEYS), None
    cache = jinputs.cache_shapes(model, B, S)
    toks = {"tokens": jax.ShapeDtypeStruct((B, 1), jnp.int32)}
    return (_bytes(params, psh) + _bytes(cache, jinputs.cache_shardings(cache, mesh))
            + _bytes(toks, jinputs.batch_input_shardings(toks, mesh), TOKEN_KEYS) + 4), None


CASES = [(a, s, mp, st) for a in ARCHS for s in SHAPES for mp in (False, True)
         for st in STRATEGIES]


@pytest.mark.parametrize("arch,shape,mp,strategy", CASES,
                         ids=[f"{a}-{s}-{'pod2' if mp else 'pod1'}-{st}"
                              for a, s, mp, st in CASES])
def test_dryrun_record_matches_the_reference(records, arch, shape, mp, strategy):
    rec = records[(arch, shape, mp, strategy)]
    supported = jconfigs.shape_supported(jconfigs.get_config(arch), shape)
    assert supported == tconfigs.shape_supported(tconfigs.get_config(arch), shape)
    if not supported:
        assert rec["status"] == "skipped" and "long_500k" in rec["reason"]
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == (512 if mp else 256)
    want_bytes, C = _ref_argument_bytes(arch, shape, mp, strategy)
    assert rec["argument_size_in_bytes"] == want_bytes
    if C is not None:
        assert rec["num_clients"] == C
        # the schedule's all-reduces: the client-mean loss at least
        assert rec["all-reduce_count"] >= 1
    assert rec["flops"] > 0 and rec["bytes_accessed"] > rec["executed_param_bytes_per_device"]
    assert rec["model_axis"] == "replicated"
    for kind, op in (("all-reduce", "c10d.allreduce_"), ("all-gather", "c10d._allgather_base_")):
        assert rec.get(f"{kind}_count", 0.0) == rec["comm_debug_counts"].get(op, 0)


def test_records_round_trip_through_the_roofline(records, tmp_path):
    for (arch, shape, mp, strat), rec in records.items():
        tag = dryrun.record_tag(arch, shape, mp, strat)
        (tmp_path / f"{tag}.json").write_text(json.dumps(rec))
    rows = roofline.run(verbose=False, results_dir=str(tmp_path))
    ok = [r for r in records.values() if r["status"] == "ok"]
    assert len(rows) == len(ok) == 24
    for r in ok:
        a = roofline.analyze(r)
        assert a["scan_corr"] == 1.0 and a["bottleneck"] in ("compute", "memory", "collective")
        assert np.isfinite(a["step_time_lb_s"]) and a["step_time_lb_s"] > 0
        assert a["t_compute_s"] == r["flops"] / roofline.PEAK_FLOPS


def test_cli_tags_and_skip_cached(tmp_path, capsys):
    argv = ["--arch", "debug-dense", "--shape", "long_500k", "--both-meshes",
            "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["debug-dense__long_500k__pod1__cfl.json",
                     "debug-dense__long_500k__pod2__cfl.json"]
    assert json.loads((tmp_path / names[0]).read_text())["status"] == "skipped"
    assert dryrun.main(argv) == 0
    assert capsys.readouterr().out.count("[skip cached]") == 2
    assert dryrun.record_tag("debug-moe", "train_4k", True, "enfed", True, "ep", 64, "int8") == \
        "debug-moe__train_4k__pod2__enfed__absorbed__ep__chunk64__int8"


def test_dryrun_needs_no_device_and_counts_every_layer():
    """Flops of a 2-, 4- and 6-layer ``debug-dense`` prefill step on the
    fake group: linear in the layer count (every layer counted, so the
    roofline's scan correction is 1), the 4-layer model's twice the
    2-layer one's less the prologue (embedding, unembedding)."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.transformer import Transformer
    from repro_torch.sharding.ctx import use_mesh

    flops = {}
    try:
        dryrun._fake_group(256)
        mesh = make_production_mesh()
        for layers in (2, 4, 6):
            cfg = tconfigs.get_config("debug-dense").replace(num_layers=layers)
            counter = FlopCounterMode(display=False)
            with use_mesh(mesh), counter:
                dryrun.lower_prefill(cfg, Transformer(cfg, device="meta"), mesh, "prefill_32k")
            flops[layers] = counter.get_total_flops()
    finally:
        dist.destroy_process_group()
    assert flops[6] - flops[4] == flops[4] - flops[2] > 0
    prologue = 2 * flops[2] - flops[4]
    assert 0 <= prologue < 0.5 * flops[2]
    assert roofline.scan_correction(tconfigs.get_config("debug-dense")) == 1.0
    assert not torch.cuda.is_initialized()
