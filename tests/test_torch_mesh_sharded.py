"""The port's mesh steps executed sharded, on 8 gloo ranks of this CPU,
against the reference's on 8 fake host devices whose arguments carry the
reference's placements (``fed_param_shardings`` or ``param_specs`` as
``in_shardings`` and ``out_shardings``).

Each rank holds only its block of every param and Adam leaf; the ``model``
axis, and ``data`` under fsdp, run sharded.  The cases: ``debug-dense``
on (2, 2, 2) for every strategy and ``none``; on (4, 2) with ``cfl``;
``debug-dense`` with fsdp on (2, 2, 2) (federating over ``pod``, ``data``
as ZeRO-3) and on (4, 2) (plain data parallel); ``debug-moe`` with fsdp
on (4, 2) and on (2, 2, 2) (plain data parallel).  ``debug-moe`` on
(2, 2, 2) for every strategy and ``none`` runs sharded in
``tests/test_torch_distributed_train.py``.  One step from the reference's
weights on one seeded 8 x 16 batch:

* losses within ``LOSS_ATOL``;
* the params gathered whole by the rule of
  ``tests/test_torch_distributed_train.py`` (max gap within two Adam
  steps, few elements beyond ``FAR``);
* each rank's param and Adam blocks of the shape
  ``NamedSharding.shard_shape`` gives, each param block equal to the
  reference's ``addressable_shards`` entry of the device of the rank's
  index by the same rule (both meshes are ``arange(8).reshape(shape)``);
* each rank's held bytes: the params' and Adam's ``mu`` and ``nu`` blocks,
  three times the per-rank parameter bytes of the closed form.

The reference runs in one subprocess while the port's ranks run.  Its
XLA-CPU partitioner fails on two fsdp cases:

* ``debug-dense`` with fsdp on (2, 2, 2) aborts (``REFERENCE_ABORTS``).
  That case is held against the port's own step on one device, whole
  params and the whole batch, which ``cfl`` over two equal clients with
  every client in equals: the loss, the params of each client, and each
  rank's block of them.
* ``debug-moe`` with fsdp on (2, 2, 2) runs, but its update disagrees with
  the reference's own run of the same step under the placements without
  fsdp on ~10 % of the elements (equal losses; the gradients of every
  leaf before the MoE's output differ).  The port's runs with and without
  fsdp agree, and the latter is the reference's
  (``tests/test_torch_distributed_train.py``).  So that case is held
  against the reference's step run under the placements without fsdp
  (``REFERENCE_PLACED_WITHOUT_FSDP``), its output re-placed under the
  fsdp specs: the values the placements must not change."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import _torch_mesh_ranks as ranks  # noqa: E402

LOSS_ATOL = 5e-6
LR = 1e-3
PARAM_ATOL = 2 * LR
FAR, FAR_SHARE = 1e-5, 1e-4
KINDS = ("cfl", "enfed", "dfl_ring", "dfl_mesh", "none")

CASES = {f"dense-pod2-{k}": dict(arch="debug-dense", fsdp=False, multi=True, kind=k)
         for k in KINDS}
CASES.update({
    "dense-pod1-cfl": dict(arch="debug-dense", fsdp=False, multi=False, kind="cfl"),
    "dense-fsdp-pod2-cfl": dict(arch="debug-dense", fsdp=True, multi=True, kind="cfl"),
    "dense-fsdp-pod1-cfl": dict(arch="debug-dense", fsdp=True, multi=False, kind="cfl"),
    "moe-fsdp-pod1-cfl": dict(arch="debug-moe", fsdp=True, multi=False, kind="cfl"),
    "moe-fsdp-pod2-cfl": dict(arch="debug-moe", fsdp=True, multi=True, kind="cfl"),
})

# the reference's XLA-CPU partitioner (jax 0.9.0) aborts on these cases:
REFERENCE_ABORTS = {
    "dense-fsdp-pod2-cfl": "spmd_partitioner_util.cc:495 Check failed: "
                           "partition_group_list.num_replica_groups() * "
                           "partition_group_list.num_devices_per_group() == "
                           "device_groups.num_devices_per_group()",
}

# ... and gives another update under these placements than without fsdp:
REFERENCE_PLACED_WITHOUT_FSDP = ("moe-fsdp-pod2-cfl",)

# per-rank parameter bytes of each preset's blocks (fsdp, mesh), from the
# reference's specs and shard shapes: every split is even, so every rank
# holds the same bytes; whole, a replica is 1,708,544 (dense) and
# 2,498,048 (MoE) bytes
PARAM_BYTES = {("debug-dense", False, True): 856_576, ("debug-dense", False, False): 856_576,
               ("debug-dense", True, True): 430_592, ("debug-dense", True, False): 217_600,
               ("debug-moe", False, True): 1_381_632, ("debug-moe", True, False): 1_234_176,
               ("debug-moe", True, True): 1_283_328}

_REFERENCE = r"""
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.topology import AggregationStrategy
from repro.launch.inputs import batch_input_shardings
from repro.launch.mesh import client_axes_for, make_debug_mesh
from repro.launch.steps import (fed_param_shardings, make_federated_train_step, num_clients,
                                stack_for_clients)
from repro.models import Transformer
from repro.sharding import param_specs, use_mesh

tr = pickle.load(open(sys.argv[1], "rb"))
out = {}
batch = {k: jnp.asarray(v, jnp.int32) for k, v in tr["batch"].items()}
for name, case in tr["ref_cases"].items():
    mesh = make_debug_mesh(multi_pod=case["multi"])
    assert [d.id for d in mesh.devices.reshape(-1)] == list(range(8))
    cfg = get_config(case["arch"])
    if case["fsdp"]:
        cfg = cfg.replace(fsdp=True)
    model = Transformer(cfg)
    caxes = client_axes_for(cfg, mesh)
    C = num_clients(mesh, caxes)
    params = jax.tree_util.tree_map(jnp.asarray, tr["params"][case["arch"]])
    strat = AggregationStrategy(kind=case["kind"], client_axes=caxes, neighborhood_size=2)
    mask = jnp.ones((max(C, 1),), jnp.float32)
    with use_mesh(mesh):
        step, opt = make_federated_train_step(model, mesh, strat, lr=tr["lr"])
        if case["kind"] == "none" or not caxes:
            p, o = params, opt.init(params)
            psh = param_specs(p, mesh, fsdp=cfg.fsdp)
            osh = param_specs(o, mesh, fsdp=cfg.fsdp)
            run = case.get("placed_fsdp", cfg.fsdp)
            psh_run = param_specs(p, mesh, fsdp=run)
            osh_run = param_specs(o, mesh, fsdp=run)
            bsh = batch_input_shardings(batch, mesh)
        else:
            p, o = stack_for_clients(params, C), stack_for_clients(opt.init(params), C)
            psh = fed_param_shardings(jax.eval_shape(lambda: p), mesh, caxes, cfg.fsdp)
            osh = fed_param_shardings(jax.eval_shape(lambda: o), mesh, caxes, cfg.fsdp)
            bsh = batch_input_shardings(batch, mesh, client_stacked=True, client_axes=caxes)
            psh_run, osh_run = psh, osh
        p2, o2, loss = jax.jit(step, in_shardings=(psh_run, osh_run, bsh, None),
                               out_shardings=(psh_run, osh_run, None))(p, o, batch, mask)
        p2 = jax.device_put(p2, psh)
    blocks = jax.tree_util.tree_map(
        lambda a: [np.asarray(s.data) for s in sorted(a.addressable_shards,
                                                      key=lambda s: s.device.id)], p2,
        is_leaf=lambda x: isinstance(x, jax.Array))
    shard_shapes = jax.tree_util.tree_map(
        lambda a, sh: sh.shard_shape(a.shape), (p, o.mu, o.nu), (psh, osh.mu, osh.nu))
    out[name] = dict(loss=float(loss), params=jax.tree_util.tree_map(np.asarray, p2),
                     blocks=blocks, shard_shapes=shard_shapes)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs():
    from repro.configs import get_config
    from repro.models import Transformer as JTransformer

    rng = np.random.default_rng(28)
    params = {arch: jax.tree_util.tree_map(
        np.asarray, JTransformer(get_config(arch)).init(jax.random.PRNGKey(0)))
        for arch in ("debug-dense", "debug-moe")}
    toks = rng.integers(0, 512, (8, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int64), "labels": toks[:, 1:].astype(np.int64)}
    data = dict(params=params, lr=LR, cases=CASES, batch=batch,
                ref_cases={k: dict(v, placed_fsdp=False) if k in REFERENCE_PLACED_WITHOUT_FSDP
                           else v for k, v in CASES.items() if k not in REFERENCE_ABORTS})
    ref, per_rank = ranks.run_with_reference(_REFERENCE, data, ranks.sharded_steps)
    for name in REFERENCE_ABORTS:
        ref[name] = _one_device_twin(CASES[name], params[CASES[name]["arch"]], batch,
                                     per_rank[0][name]["specs"])
    return dict(ref=ref, port=per_rank)


def _one_device_twin(case, params, batch, specs):
    """The port's step on one device (whole params, whole batch) in the
    reference's record: ``cfl`` over equal clients, all in, is that step on
    every client."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.topology import AggregationStrategy
    from repro_torch.launch import steps
    from repro_torch.models.transformer import Transformer
    from repro_torch.sharding.specs import P, coordinates, leaf_block, shard_shape
    from repro_torch.utils.tree import from_jax_params

    assert case["kind"] == "cfl"
    cfg = get_config(case["arch"]).replace(fsdp=case["fsdp"])
    model = Transformer(cfg, device="cpu")
    step, opt = steps.make_federated_train_step(model, None, AggregationStrategy(), lr=LR)
    whole = from_jax_params(params, torch.device("cpu"))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        p2, _, loss = step(whole, opt.init(whole), {k: torch.from_numpy(v) for k, v in
                                                    batch.items()}, None)
    finally:
        torch.set_num_threads(prev)
    mesh = _mesh(case)
    C = 2                                            # the pods
    full = {k: np.broadcast_to(v, (C,) + v.shape).copy() for k, v in _leaves(
        ranks._np(p2)).items()}
    blocks = {k: np.stack([leaf_block(torch.from_numpy(v), P(*specs[k]), mesh, c).numpy()
                           for c in coordinates(mesh)]) for k, v in full.items()}
    shapes = {k: shard_shape(v.shape, P(*specs[k]), mesh) for k, v in full.items()}
    return dict(loss=float(loss), params=_nest(full), blocks=_nest(blocks),
                shard_shapes=(_nest(shapes),) * 3)


def _nest(flat):
    """``{"/a/b": leaf}`` as nested dicts."""
    out = {}
    for path, v in flat.items():
        keys = path.strip("/").split("/")
        d = out
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = v
    return out


def _assert_close(got, want, what):
    """The rule of ``tests/test_torch_distributed_train.py`` over every
    pair of leaves."""
    total = far = 0
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, (what, path, g.shape, w.shape)
        gap = np.abs(g - w)
        assert gap.max() <= PARAM_ATOL, (what, path, gap.max())
        total += gap.size
        far += int((gap > FAR).sum())
    assert far <= FAR_SHARE * total, f"{what}: {far} of {total} elements beyond {FAR}"


def _leaves(tree):
    return dict(ranks.tree_items(tree))


def _mesh(case):
    from repro_torch.sharding.specs import AbstractMesh

    return AbstractMesh(("pod", "data", "model"), (2, 2, 2)) if case["multi"] else \
        AbstractMesh(("data", "model"), (4, 2))


@pytest.mark.parametrize("name", CASES)
def test_sharded_step_loss_and_params_match_the_reference(runs, name):
    """Every rank's loss; the ranks' blocks put together in the
    reference's layout (client-stacked but for plain data parallel)."""
    import torch

    from repro_torch.sharding.specs import P, leaf_from_blocks

    case, want = CASES[name], runs["ref"][name]
    for per_rank in runs["port"]:
        assert abs(per_rank[name]["loss"] - want["loss"]) <= LOSS_ATOL, \
            (per_rank[name]["loss"], want["loss"])
    specs = runs["port"][0][name]["specs"]
    per_rank = [_leaves(r[name]["blocks"]) for r in runs["port"]]
    got = {k: leaf_from_blocks([torch.from_numpy(b[k]) for b in per_rank], P(*specs[k]),
                               _mesh(case)).numpy() for k in per_rank[0]}
    _assert_close(got, _leaves(want["params"]), name)


@pytest.mark.parametrize("name", CASES)
def test_rank_blocks_match_the_reference_shards(runs, name):
    """Each rank's param block is the reference's shard on the device of
    the rank's index; its param and Adam blocks have the shard shapes."""
    want = runs["ref"][name]
    ref_blocks = _leaves(want["blocks"])                   # (8, *block) per leaf
    p_shapes, mu_shapes, nu_shapes = (_leaves(t) for t in want["shard_shapes"])
    for rank, per_rank in enumerate(runs["port"]):
        got = per_rank[name]
        blocks = _leaves(got["blocks"])
        assert set(blocks) == set(ref_blocks) == set(got["adam"]["mu"])
        for k, b in blocks.items():
            assert b.shape == tuple(p_shapes[k]), (k, b.shape, p_shapes[k])
            assert tuple(got["adam"]["mu"][k]) == tuple(mu_shapes[k]), k
            assert tuple(got["adam"]["nu"][k]) == tuple(nu_shapes[k]), k
        _assert_close(blocks, {k: v[rank] for k, v in ref_blocks.items()}, f"{name} rank {rank}")


@pytest.mark.parametrize("name", CASES)
def test_held_bytes_match_the_closed_form(runs, name):
    """Params, ``mu`` and ``nu``: three times the per-rank parameter bytes,
    on every rank."""
    case = CASES[name]
    want = 3 * PARAM_BYTES[(case["arch"], case["fsdp"], case["multi"])]
    assert [r[name]["held"] for r in runs["port"]] == [want] * 8
