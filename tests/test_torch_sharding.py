"""The port's sharding rules against the reference's, leaf for leaf.

The reference's rules run on ``jax.sharding.AbstractMesh`` (no devices),
the port's on its ``AbstractMesh``, for every leaf of both presets, under
fsdp on and off, on the production meshes (16, 16) and (2, 16, 16) and the
debug meshes (4, 2) and (2, 2, 2): ``param_specs``,
``fed_param_shardings`` (client-stacked), ``batch_input_shardings``
(client-stacked or not), ``cache_shardings`` (B = 128, S = 32,768 and
B = 1, S = 4,096, the second reaching the sequence branch) and
``input_specs_sharding``.  Specs must be equal exactly.  Also:
``client_axes_for``, ``num_clients``, ``to_placements`` and
``shard_activation`` on a plain tensor and on a DTensor over a fake-group
mesh, and ``_spec_for``'s branches one by one."""

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch import inputs as jinputs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.launch import inputs, mesh as tmesh, steps  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.sharding import ctx as tctx, specs  # noqa: E402

MESHES = {
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "4x2": (("data", "model"), (4, 2)),
    "2x2x2": (("pod", "data", "model"), (2, 2, 2)),
}
PRESETS = ("debug-dense", "debug-moe")


def _meshes(name):
    names, sizes = MESHES[name]
    return JAbstractMesh(sizes, names), specs.AbstractMesh(names, sizes)


def _ref_specs(tree):
    """{path: spec tuple} of a tree of reference NamedShardings."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jspecs._path_str(p): tuple(s.spec) for p, s in flat}


def _port_specs(tree):
    return {p: tuple(s) for p, s in specs.leaves_with_path(tree)}


def _assert_equal(port, ref):
    assert set(port) == set(ref), sorted(set(port) ^ set(ref))
    bad = {k: (port[k], ref[k]) for k in ref if port[k] != ref[k]}
    assert not bad, bad


_SHAPES = {}


def _shapes(arch, what):
    """Reference shape tree and the port's meta tree of one preset."""
    key = (arch, what)
    if key not in _SHAPES:
        jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
        jm, tm = JTransformer(jcfg), Transformer(tcfg, device="meta")
        if what == "params":
            ref = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
            port = tm.init(torch.Generator().manual_seed(0))
        elif what == "opt":
            ref = jax.eval_shape(jadam(1e-4).init, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
            port = adam(1e-4).init(tm.init(torch.Generator().manual_seed(0)))
        else:
            b, s = what
            ref = jinputs.cache_shapes(jm, b, s)
            port = inputs.cache_shapes(tm, b, s)
        _SHAPES[key] = (ref, port)
    return _SHAPES[key]


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("what", ["params", "opt"])
@pytest.mark.parametrize("arch", PRESETS)
def test_param_specs_match_the_reference_on_every_leaf(arch, what, fsdp, mesh_name):
    jm, tm = _meshes(mesh_name)
    ref, port = _shapes(arch, what)
    _assert_equal(_port_specs(specs.param_specs(port, tm, fsdp=fsdp)),
                  _ref_specs(jspecs.param_specs(ref, jm, fsdp=fsdp)))


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", PRESETS)
def test_fed_param_shardings_match_the_reference(arch, fsdp, mesh_name):
    jm, tm = _meshes(mesh_name)
    jcfg = jconfigs.get_config(arch).replace(fsdp=fsdp)
    tcfg = tconfigs.get_config(arch).replace(fsdp=fsdp)
    caxes = jmesh.client_axes_for(jcfg, jm)
    assert tmesh.client_axes_for(tcfg, tm) == caxes
    C = jsteps.num_clients(jm, caxes)
    assert steps.num_clients(tm, caxes) == C
    ref, port = _shapes(arch, "params")
    ref_c = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct((C,) + x.shape, x.dtype), ref)
    port_c = steps.stack_for_clients(port, C)
    _assert_equal(_port_specs(steps.fed_param_shardings(port_c, tm, caxes, fsdp)),
                  _ref_specs(jsteps.fed_param_shardings(ref_c, jm, caxes, fsdp)))


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
def test_batch_input_shardings_match_the_reference(shape, stacked, mesh_name):
    jm, tm = _meshes(mesh_name)
    shp = jconfigs.INPUT_SHAPES[shape]
    jcfg, tcfg = jconfigs.get_config("debug-dense"), tconfigs.get_config("debug-dense")
    caxes = jmesh.client_axes_for(jcfg, jm)
    B, S = shp["global_batch"], shp["seq_len"]
    if shp["kind"] == "decode":
        ref, port = jinputs.decode_inputs(jcfg, B), inputs.decode_inputs(tcfg, B)
    else:
        ref, port = jinputs.train_inputs(jcfg, B, S), inputs.train_inputs(tcfg, B, S)
    _assert_equal(
        _port_specs(inputs.batch_input_shardings(port, tm, client_stacked=stacked,
                                                 client_axes=caxes)),
        _ref_specs(jinputs.batch_input_shardings(ref, jm, client_stacked=stacked,
                                                 client_axes=caxes)))
    _assert_equal(_port_specs(specs.input_specs_sharding(port, tm)),
                  _ref_specs(jspecs.input_specs_sharding(ref, jm)))


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("bs", [(128, 32_768), (1, 4_096)], ids=["B128_S32768", "B1_S4096"])
@pytest.mark.parametrize("arch", PRESETS)
def test_cache_shardings_match_the_reference(arch, bs, mesh_name):
    jm, tm = _meshes(mesh_name)
    ref, port = _shapes(arch, bs)
    got = _port_specs(inputs.cache_shardings(port, tm))
    _assert_equal(got, _ref_specs(jinputs.cache_shardings(ref, jm)))
    if bs == (1, 4_096) and mesh_name != "2x2x2":
        # the sequence branch: a 4,096-long axis goes on 'data'
        assert any("data" in s for s in got.values()), got


def test_moe_decode_cache_example():
    """The spec the reference gives ``debug-moe``'s decode cache at
    B = 128, S = 32,768 on (2, 16, 16)."""
    _, tm = _meshes("2x16x16")
    _, port = _shapes("debug-moe", (128, 32_768))
    got = _port_specs(inputs.cache_shardings(port, tm))
    assert got["scan/p0_attn/k"] == (None, ("pod", "data"), None, None, "model")


# ---------------------------------------------------------------------------
# _spec_for's branches
# ---------------------------------------------------------------------------

BRANCHES = {
    # path, shape, mesh, fsdp
    "one_d_replicated": ("scan/p0_attn/norm1", (2, 128), "16x16", True),
    "scalar": ("step", (), "16x16", True),
    "embed_model_and_data": ("embed", (512, 128), "4x2", True),
    "embed_model_only": ("embed", (512, 128), "16x16", True),
    "embed_data_fallback": ("embed", (48, 128), "16x16", True),
    "embed_not_divisible": ("embed", (513, 128), "16x16", True),
    "embed_no_fsdp": ("embed", (512, 128), "4x2", False),
    "router_model": ("scan/p0_attn/ffn/router", (2, 128, 16), "16x16", True),
    "router_not_divisible": ("scan/p0_attn/ffn/router", (2, 128, 4), "16x16", True),
    "expert_model": ("scan/p0_attn/ffn/wg", (2, 16, 128, 64), "16x16", True),
    "expert_not_divisible": ("scan/p0_attn/ffn/wd", (2, 4, 64, 128), "16x16", True),
    "tp_and_fsdp": ("scan/p0_attn/mixer/wq", (2, 128, 128), "16x16", True),
    "tp_last_most": ("unembed", (128, 512), "4x2", True),
    "fsdp_largest_other": ("tail0_attn/mixer/wo", (64, 96), "2x2x2", True),
    "tp_only_no_fsdp": ("scan/p0_attn/mixer/wk", (2, 128, 64), "16x16", False),
    "encoder_leading_axis": ("encoder/blocks/mixer/wq", (2, 128, 128), "4x2", True),
    "nothing_divisible": ("mtp/proj", (3, 5), "4x2", True),
    "opt_state_path": (".mu/scan/p0_attn/mixer/wq", (2, 128, 128), "4x2", True),
}


@pytest.mark.parametrize("case", BRANCHES)
def test_spec_for_branch_matches_the_reference(case):
    path, shape, mesh_name, fsdp = BRANCHES[case]
    jm, tm = _meshes(mesh_name)
    assert tuple(specs._spec_for(path, shape, tm, fsdp=fsdp)) == \
        tuple(jspecs._spec_for(path, shape, jm, fsdp=fsdp))


# ---------------------------------------------------------------------------
# the context, the client axes and placements
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", MESHES)
def test_client_axes_and_context_resolve_like_the_reference(mesh_name):
    jm, tm = _meshes(mesh_name)
    for arch in PRESETS:
        for fsdp in (False, True):
            jcfg = jconfigs.get_config(arch).replace(fsdp=fsdp)
            tcfg = tconfigs.get_config(arch).replace(fsdp=fsdp)
            assert tmesh.client_axes_for(tcfg, tm) == jmesh.client_axes_for(jcfg, jm)
    from repro.sharding.ctx import MeshContext as JMeshContext

    jc, tc = JMeshContext(jm), tctx.MeshContext(tm)
    assert tc.batch_axes == jc.batch_axes and tc.model_axis == jc.model_axis
    for logical in [("batch", None, "model"), ("expert", None, None), ("data", "pod", "x")]:
        assert tuple(tc.resolve(logical)) == tuple(jc.resolve(logical))


def test_mesh_needs_enough_ranks():
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="fake process group"):
        tmesh.make_debug_mesh(multi_pod=True)


@pytest.fixture(scope="module")
def fake_mesh():
    """A (2, 2, 2) DeviceMesh on an in-process fake group of 8 ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield tmesh.make_debug_mesh(multi_pod=True)
    finally:
        dist.destroy_process_group()


def test_shard_activation_on_plain_tensor_and_dtensor(fake_mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    x = torch.arange(48.0).reshape(4, 3, 4)
    assert tctx.shard_activation(x, ("batch", None, "model")) is x
    with tctx.use_mesh(fake_mesh):
        assert tctx.shard_activation(x, ("batch", None, "model")) is x
        dt = DTensor.from_local(x, fake_mesh, [Replicate()] * 3)
        out = tctx.shard_activation(dt, ("batch", None, "model"))
        assert list(out.placements) == [Shard(0), Shard(0), Shard(2)]
        with tctx.manual_axes(("pod", "data")):
            out = tctx.shard_activation(dt, ("batch", None, "model"))
            assert list(out.placements) == [Replicate(), Replicate(), Shard(2)]
    assert tctx.pvary_manual(x) is x


def test_to_placements_orders_mesh_axes(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard

    assert specs.to_placements(specs.P(None, ("pod", "data"), "model"), fake_mesh) == \
        [Shard(1), Shard(1), Shard(2)]
    assert specs.to_placements(specs.P(), fake_mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):
        specs.to_placements(specs.P(("data", "pod")), fake_mesh)
    with pytest.raises(ValueError):
        specs.to_placements(specs.P("data", "data"), fake_mesh)


@pytest.mark.parametrize("kind", ["cfl", "none"])
def test_mesh_step_refuses_tensors_off_the_models_device(kind):
    """A rank whose tensors are not on its model's device raises before
    any collective: no fallback hides the device."""
    from repro_torch.core.topology import AggregationStrategy

    model = Transformer(tconfigs.get_config("debug-dense"), device="cpu")
    mesh = specs.AbstractMesh(("data", "model"), (4, 2))
    step, opt = steps.make_federated_train_step(
        model, mesh, AggregationStrategy(kind=kind, client_axes=("data",)))
    params = Transformer(tconfigs.get_config("debug-dense"), device="meta").init(
        torch.Generator().manual_seed(0))
    batch = {k: torch.zeros((8, 4), dtype=torch.int64) for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="every rank computes on its model's device"):
        step(steps.stack_for_clients(params, 1), steps.stack_for_clients(opt.init(params), 1),
             batch, torch.ones(4))


def test_carried_context_reaches_another_thread():
    """Autograd recomputes a checkpointed block on the card's device
    thread: ``carried`` takes the caller's mesh context (manual axes, rows)
    and the MoE's fp32 boundary there; the state stays thread-local."""
    import threading

    from repro_torch.models import moe

    mesh = specs.AbstractMesh(("pod", "data", "model"), (2, 2, 2))
    seen = {}

    def probe():
        ctx = tctx.current_mesh_context()
        return (ctx.mesh, ctx.manual, ctx.rows) if ctx else None, \
            getattr(moe._TL_STATE, "off", False)

    with tctx.use_mesh(mesh), tctx.row_axes(("data", "pod")), tctx.manual_axes(("pod",)), \
            moe.disable_token_local():
        fn = moe.carried(tctx.carried(probe))
        plain = threading.Thread(target=lambda: seen.update(plain=probe()))
        plain.start()
        plain.join()
        t = threading.Thread(target=lambda: seen.update(carried=fn()))
        t.start()
        t.join()
        assert probe() == seen["carried"]
    assert seen["plain"] == (None, False)
    assert seen["carried"] == ((mesh, frozenset({"pod"}), ("data", "pod")), True)
    assert tctx.current_mesh_context() is None
