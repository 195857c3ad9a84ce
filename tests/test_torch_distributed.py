"""The port's mesh runtime on 8 gloo ranks of this CPU against the
reference's on 8 fake host devices: the tier-1 twins of
``tests/test_distributed.py``.

* Aggregation: the reference's ``aggregate_local`` under a ``shard_map``
  whose in_specs give every client its own update, against the port's
  ``aggregate_updates`` on 8 ranks, for every strategy, both masks, both
  ``compress`` values, single and multi-pod, and ``pod_local``.  Sums that
  only ring hops and two-rank all-reduces make (a two-value sum is the same
  in either order) are bitwise equal; the others, and int8 rings (whose
  hop add XLA may fuse into one multiply-add), within ``AGG_TOL``, far
  below the step one int8 code apart makes, so the codes are equal.  The
  same results against a numpy oracle of each strategy's masked means.
  The recorder's collective bytes equal their closed form and its counts
  ``CommDebugMode``'s.
* MoE schedules: ``moe_apply`` with ``dispatch="ep"`` (expert parallel),
  ``"sort"`` and ``"einsum"`` (token-local) on both meshes, output, aux
  and the gradient of ``sum(y * r) + aux`` within ``MOE_TOL``: with whole
  params (the serve step's layout) and with each rank's blocks (its
  experts and router columns; the train and prefill steps' layout).
* The leaf blocks' collectives: ``gather`` and ``scatter_sum`` on 8 ranks,
  values and gradients against one process's computation, and the
  recorder's bytes against their closed form.

The train-step twin is ``tests/test_torch_distributed_train.py``.  The
reference runs once per file in one subprocess; the port's ranks run
through ``repro_torch.launch.mesh.spawn`` while it does."""


import numpy as np
import pytest

jax = pytest.importorskip("jax")

import _torch_mesh_ranks as ranks  # noqa: E402

AGG_TOL = dict(atol=1e-6, rtol=1e-6)
MOE_TOL = dict(atol=2e-5, rtol=1e-5)
DISPATCHES = ("ep", "sort", "einsum")
LEAF = (16, 8)
# (kind, multi-pod, spec, gathered axes, axes summed backward): the fsdp
# embedding's data part, a ZeRO-3 leaf gathered whole (data summed, model
# cut), a hidden gathered over model (summed: output-split projection) or
# cut (replicated use), and reduce-scatters of whole values
LEAF_CASES = {
    "gather-embed-fsdp": dict(kind="gather", multi=False, spec=(("data", "model"), None),
                              axes=("data",), summed=("data",)),
    "gather-zero3": dict(kind="gather", multi=False, spec=("data", "model"), axes=None,
                         summed=("data",)),
    "gather-hidden-summed": dict(kind="gather", multi=True, spec=(None, "model"), axes=None,
                                 summed=("model",)),
    "gather-rows-cut": dict(kind="gather", multi=True, spec=("model", None), axes=None,
                            summed=()),
    "gather-two-axes-cut": dict(kind="gather", multi=True, spec=(("pod", "data"), "model"),
                                axes=None, summed=()),
    "scatter-2d": dict(kind="scatter", multi=False, spec=("data", "model"), axes=None,
                       summed=None),
    "scatter-tuple": dict(kind="scatter", multi=True, spec=(None, ("data", "model")),
                          axes=None, summed=None),
}


def _cases():
    cases = {}
    for multi in (False, True):
        combos = [("cfl", 0, None), ("dfl_mesh", 0, None), ("dfl_ring", 0, None),
                  ("dfl_ring", 0, "int8"), ("enfed", 2, None), ("enfed", 2, "int8"),
                  ("enfed", 0, None)]
        for kind, k, compress in combos:
            for pod_local in ((False, True) if multi and kind == "enfed" else (False,)):
                for mask in ("ones", "one_zero"):
                    name = (f"{'pod2' if multi else 'pod1'}-{kind}-k{k}-{compress}"
                            f"-{'podlocal' if pod_local else 'global'}-{mask}")
                    cases[name] = dict(multi=multi, kind=kind, k=k, compress=compress,
                                       pod_local=pod_local, mask=mask)
    return cases


CASES = _cases()

_REFERENCE = r"""
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.core.topology import AggregationStrategy, aggregate_local
from repro.launch.mesh import make_debug_mesh
from repro.models import moe
from repro.sharding import use_mesh

data = pickle.load(open(sys.argv[1], "rb"))
out = {"agg": {}, "moe": {}}
meshes = {False: make_debug_mesh(), True: make_debug_mesh(multi_pod=True)}

for name, case in data["cases"].items():
    mesh = meshes[case["multi"]]
    axes = ("pod", "data") if case["multi"] else ("data",)
    cspec = axes if len(axes) > 1 else axes[0]
    s = AggregationStrategy(kind=case["kind"], client_axes=axes,
                            neighborhood_size=case["k"], pod_local=case["pod_local"],
                            compress=case["compress"])

    def body(u, m, s=s, mesh=mesh, axes=axes):
        u = jax.tree_util.tree_map(lambda x: x[0], u)
        res = aggregate_local(u, m, mesh, s)

        def mark(x):
            vma = getattr(jax.typeof(x), "vma", frozenset())
            missing = tuple(a for a in axes if a not in vma)
            if missing:
                x = jax.lax.pcast(x, missing, to="varying")
            return x[None]
        return jax.tree_util.tree_map(mark, res)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, axis_names=set(axes),
                               in_specs=(P(cspec), P()), out_specs=P(cspec)))
    u = {k: jnp.asarray(v) for k, v in data["updates"].items()}
    res = fn(u, jnp.asarray(data["masks"][case["mask"]]))
    out["agg"][name] = {k: np.asarray(v) for k, v in res.items()}

mo = data["moe"]
for multi, mesh in meshes.items():
    for dispatch in mo["dispatches"]:
        c = get_config("debug-moe")
        import dataclasses
        c = c.replace(moe=dataclasses.replace(c.moe, dispatch=dispatch))
        p = jax.tree_util.tree_map(jnp.asarray, mo["params"])
        x, r = jnp.asarray(mo["x"]), jnp.asarray(mo["r"])

        def f(t, c=c, r=r):
            y, aux = moe.moe_apply(t["p"], t["x"], c)
            return jnp.sum(y * r) + aux, (y, aux)

        with use_mesh(mesh):
            (val, (y, aux)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
                {"p": p, "x": x})
        out["moe"][(multi, dispatch)] = dict(
            y=np.asarray(y), aux=float(aux), val=float(val),
            grads=jax.tree_util.tree_map(np.asarray, g))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs():
    """Inputs from one numpy seed; the reference's run in a subprocess of
    8 fake host devices, the port's 8 ranks meanwhile."""
    from repro.configs import get_config
    from repro.models.moe import moe_init

    rng = np.random.default_rng(27)
    C = 4
    updates = {"w": (rng.standard_normal((C, 6, 5)) * rng.uniform(0.1, 10, (C, 1, 1)))
               .astype(np.float32),
               "b": rng.standard_normal((C, 7)).astype(np.float32)}
    masks = {"ones": np.ones(C, np.float32),
             "one_zero": np.array([1.0, 0.0, 1.0, 1.0], np.float32)}
    cfg = get_config("debug-moe")
    moe_params = jax.tree_util.tree_map(np.asarray, moe_init(jax.random.PRNGKey(3), cfg))
    moe_data = dict(params=moe_params, dispatches=DISPATCHES,
                    x=rng.standard_normal((8, 16, cfg.d_model)).astype(np.float32),
                    r=rng.standard_normal((8, 16, cfg.d_model)).astype(np.float32))
    data = dict(cases=CASES, updates=updates, masks=masks, moe=moe_data,
                leaf_cases=LEAF_CASES, leaf=rng.standard_normal(LEAF).astype(np.float32),
                values=rng.standard_normal((8,) + LEAF).astype(np.float32),
                weights=rng.standard_normal((8,) + LEAF).astype(np.float32))
    ref, per_rank = ranks.run_with_reference(_REFERENCE, data, ranks.agg_and_moe)
    return dict(ref=ref, port=dict(agg=per_rank[0]["agg"], moe=[r["moe"] for r in per_rank],
                                   leaf=[r["leaf"] for r in per_rank]),
                data=data)


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


def _bitwise(case) -> bool:
    """Ring hops and two-value sums only: dfl_ring and enfed with k < n,
    whose multi-pod finish is a two-pod all-reduce (or none, pod_local);
    not int8 hops, whose ``acc + codes * scale`` XLA may fuse into one
    multiply-add."""
    return case["compress"] is None and (
        case["kind"] == "dfl_ring" or (case["kind"] == "enfed" and case["k"] == 2))


@pytest.mark.parametrize("name", CASES)
def test_aggregation_matches_the_reference(runs, name):
    case = CASES[name]
    got, want = runs["port"]["agg"][name]["result"], runs["ref"]["agg"][name]
    for k in want:
        assert got[k].shape == want[k].shape == (4,) + runs["data"]["updates"][k].shape[1:]
        if _bitwise(case):
            assert np.array_equal(got[k].view(np.int32), want[k].view(np.int32)), \
                (k, np.abs(got[k] - want[k]).max())
        else:
            np.testing.assert_allclose(got[k], want[k], **AGG_TOL)
    if case["compress"] == "int8":
        # one code apart moves a sum by a whole scale step, absmax / 127 of
        # a hop's payload (a left-out client's payload is zeros, codes 0):
        # far above AGG_TOL, so the codes are the same
        kept = runs["data"]["masks"][case["mask"]] > 0
        step = min(np.abs(v[kept]).reshape(int(kept.sum()), -1).max(1).min() / 127
                   for v in runs["data"]["updates"].values())
        assert step > 100 * AGG_TOL["atol"]


def _closed_form(case, updates):
    """The recorder's expected (kind -> (count, bytes)) for one case."""
    leaves = [v[0] for v in updates.values()]
    W = sum(x.nbytes for x in leaves)
    L = len(leaves)
    n_data, n_pod = (2, 2) if case["multi"] else (4, 1)
    C = n_data * n_pod
    multi, kind = case["multi"], case["kind"]
    out = {}

    def add(k, count, nbytes):
        c, b = out.get(k, (0, 0))
        out[k] = (c + count, b + nbytes)

    def ring(hops, compress):
        if compress == "int8":
            add("collective-permute", hops * 2 * L, hops * sum(x.size + 4 for x in leaves))
        else:
            add("collective-permute", hops * L, hops * W)
        add("collective-permute", hops, hops * 4)           # the mask's total

    if kind == "cfl":
        add("all-reduce", 1 + L, 4 + W)
    elif kind == "dfl_mesh":
        add("all-gather", L, n_data * W)
        if multi:
            add("all-gather", L, C * W)
        add("all-reduce", 1, 4)
    elif kind == "dfl_ring":
        ring(n_data - 1, case["compress"])
        if multi:
            add("all-reduce", 1 + L, 4 + W)
    else:
        k = case["k"] or n_data
        if k >= n_data:
            add("all-reduce", 1 + L, 4 + W)
        else:
            ring(k - 1, case["compress"])
        if multi and not case["pod_local"]:
            add("all-reduce", 1 + L, 4 + W)
    return out


@pytest.mark.parametrize("name", CASES)
def test_collective_bytes_match_closed_form_and_comm_debug_mode(runs, name):
    case = CASES[name]
    r = runs["port"]["agg"][name]
    want = _closed_form(case, runs["data"]["updates"])
    got = r["bytes"]
    for kind, (count, nbytes) in want.items():
        assert got[f"{kind}_count"] == count and got[f"{kind}_bytes"] == nbytes, (kind, got)
    assert got["total_collective_bytes"] == sum(b for _, b in want.values())
    assert r["recorder"].get("all-reduce", 0) == r["comm"].get("c10d.allreduce_", 0)
    assert r["recorder"].get("all-gather", 0) == r["comm"].get("c10d._allgather_base_", 0)


def _oracle(case, updates, mask):
    """Each client's masked mean over its neighborhood, in numpy: the whole
    fleet for cfl / dfl_mesh / dfl_ring; for enfed the contiguous k-block
    of the data axis, joined over pods unless ``pod_local``."""
    n_pod, n_data = (2, 2) if case["multi"] else (1, 4)
    k = min(case["k"] or n_data, n_data)

    def group(c):
        p, d = divmod(c, n_data)
        if case["kind"] != "enfed":
            return list(range(n_pod * n_data))
        pods = [p] if case["pod_local"] else range(n_pod)
        return [q * n_data + e for q in pods for e in range(d // k * k, d // k * k + k)]

    out = {}
    for name, u in updates.items():
        rows = []
        for c in range(n_pod * n_data):
            g = group(c)
            tot = max(float(mask[g].sum()), 1e-9)
            rows.append(sum(mask[j] * u[j].astype(np.float64) for j in g) / tot)
        out[name] = np.stack(rows)
    return out


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c["compress"] is None])
def test_aggregation_strategies_numerics_twin(runs, name):
    """The reference's ``test_aggregation_strategies_numerics`` on distinct
    updates: every strategy gives its neighborhoods' masked means."""
    case = CASES[name]
    want = _oracle(case, runs["data"]["updates"], runs["data"]["masks"][case["mask"]])
    for k, v in runs["port"]["agg"][name]["result"].items():
        np.testing.assert_allclose(v, want[k], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# MoE mesh schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi", [False, True], ids=["pod1", "pod2"])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_schedules_match_the_reference_on_a_mesh(runs, dispatch, multi):
    _moe_matches(runs, dispatch, multi, "whole")


@pytest.mark.parametrize("multi", [False, True], ids=["pod1", "pod2"])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_sharded_moe_schedules_match_the_reference_on_a_mesh(runs, dispatch, multi):
    """Each rank holds its experts and router columns only: the same
    routes, output and gradients (gathered whole)."""
    _moe_matches(runs, dispatch, multi, "sharded")


def _moe_matches(runs, dispatch, multi, layout):
    want = runs["ref"]["moe"][(multi, dispatch)]
    per_rank = [r[(multi, dispatch, layout)] for r in runs["port"]["moe"]]
    for got in per_rank:
        np.testing.assert_allclose(got["y"], want["y"], **MOE_TOL)
        assert abs(got["aux"] - want["aux"]) <= 1e-6
        assert abs(got["val"] - want["val"]) <= 1e-3 * max(1.0, abs(want["val"]))
        g_items, w_items = dict(ranks.tree_items(got["grads"])), dict(ranks.tree_items(want["grads"]))
        assert set(g_items) == set(w_items)
        for path, w in w_items.items():
            np.testing.assert_allclose(g_items[path], w, err_msg=path, **MOE_TOL)


def test_ep_agrees_with_token_local_sort(runs):
    for multi in (False, True):
        ep = runs["port"]["moe"][0][(multi, "ep", "whole")]
        srt = runs["port"]["moe"][0][(multi, "sort", "whole")]
        np.testing.assert_allclose(ep["y"], srt["y"], **MOE_TOL)
        assert abs(ep["aux"] - srt["aux"]) <= 1e-6


# ---------------------------------------------------------------------------
# the leaf blocks' collectives
# ---------------------------------------------------------------------------


def _mesh_of(case):
    from repro_torch.sharding.specs import AbstractMesh

    return AbstractMesh(("pod", "data", "model"), (2, 2, 2)) if case["multi"] else \
        AbstractMesh(("data", "model"), (4, 2))


def _gathered_axes(spec, axes):
    from repro_torch.sharding.specs import P, entry_axes, spec_axes

    axes = spec_axes(spec) if axes is None else axes
    return P(*[tuple(a for a in entry_axes(e) if a in axes) or None for e in spec])


def _gathered(leaf, spec, mesh, coord, axes, dim=0):
    """One process's gather: over the gathered axes of each tensor axis,
    the blocks in their row-major order, at ``coord`` over the others."""
    import itertools

    import torch

    from repro_torch.sharding.specs import entry_axes, leaf_block

    sizes = mesh.shape
    for i in range(dim, len(spec)):
        g = [a for a in entry_axes(spec[i]) if a in axes]
        if g:
            parts = [_gathered(leaf, spec, mesh, dict(coord, **dict(zip(g, c))), axes, i + 1)
                     for c in itertools.product(*[range(sizes[a]) for a in g])]
            return torch.cat(parts, dim=i)
    return leaf_block(leaf, spec, mesh, coord)


def _peers(mesh, coord, axes):
    """The ranks whose coordinates differ from ``coord`` only along ``axes``."""
    from repro_torch.sharding.specs import coordinates

    return [r for r, c in enumerate(coordinates(mesh))
            if all(c[a] == coord[a] for a in c if a not in axes)]


def _expectation(case, data, coord):
    """(value, gradient) of one rank, from every rank's inputs in one
    process: the loss summed over the ranks, each rank's ``sum(value *
    weights[rank])``."""
    import torch

    from repro_torch.sharding.specs import P, coordinates, leaf_block, leaf_from_blocks, spec_axes

    mesh, spec = _mesh_of(case), P(*case["spec"])
    weights = lambda r, shape: torch.from_numpy(data["weights"][r][tuple(slice(0, n)
                                                                          for n in shape)])
    coords = coordinates(mesh)
    if case["kind"] == "gather":
        axes = spec_axes(_gathered_axes(spec, case["axes"]))
        value = _gathered(torch.from_numpy(data["leaf"]), spec, mesh, coord, axes)
        cut = _gathered_axes(spec, axes)
        grad = sum(leaf_block(weights(r, value.shape), cut, mesh, coord)
                   for r in _peers(mesh, coord, case["summed"]))
        return value.numpy(), grad.numpy()
    peers = _peers(mesh, coord, spec_axes(spec))
    value = leaf_block(sum(torch.from_numpy(data["values"][r]) for r in peers), spec, mesh,
                       coord)
    # every rank's block position holds the weights of the peer sitting there
    at = {tuple(coords[r][a] for a in spec_axes(spec)): r for r in peers}
    grad = leaf_from_blocks([weights(at[tuple(c[a] for a in spec_axes(spec))], value.shape)
                             for c in coords], spec, mesh)
    return value.numpy(), grad.numpy()


def _leaf_closed_form(case):
    """The recorder's events (kind, output bytes per device) forward and
    backward: one all-gather per gathered tensor axis (n times the bytes so
    far), one reduce-scatter per tensor axis with a summed axis (the bytes
    so far over the axis's blocks)."""
    from repro_torch.sharding.specs import P, entry_axes

    mesh, spec = _mesh_of(case), P(*case["spec"])
    sizes = mesh.shape
    axes = case["axes"]
    summed = case["summed"] if case["kind"] == "gather" else None
    per_dim = []
    for e in spec:
        g = [a for a in entry_axes(e) if axes is None or a in axes]
        n = int(np.prod([sizes[a] for a in g])) if g else 1
        per_dim.append((g, n, summed is None or bool(set(g) & set(summed))))
    whole = int(np.prod(LEAF)) * 4
    block = whole
    for e in spec:
        block //= int(np.prod([sizes[a] for a in entry_axes(e)])) if entry_axes(e) else 1
    gathers, nbytes = [], block if case["kind"] == "gather" else None
    if case["kind"] == "gather":
        for g, n, _ in per_dim:
            if g:
                nbytes *= n
                gathers.append(("all-gather", nbytes))
        scatters = []
        for g, n, has_sum in per_dim:
            if g:
                nbytes //= n
                if has_sum:
                    scatters.append(("reduce-scatter", nbytes))
        return gathers, scatters
    nbytes, scatters = whole, []
    for g, n, _ in per_dim:
        if g:
            nbytes //= n
            scatters.append(("reduce-scatter", nbytes))
    for g, n, _ in per_dim:
        if g:
            nbytes *= n
            gathers.append(("all-gather", nbytes))
    return scatters, gathers


@pytest.mark.parametrize("name", LEAF_CASES)
def test_leaf_collectives_match_one_process(runs, name):
    """``gather`` (values and the backward's cut or reduce-scatter) and
    ``scatter_sum`` (and its backward's gather) on 8 ranks against one
    process's computation, on every rank."""
    case = LEAF_CASES[name]
    for per_rank in runs["port"]["leaf"]:
        got = per_rank[name]
        value, grad = _expectation(case, runs["data"], got["coord"])
        np.testing.assert_allclose(got["value"], value, rtol=1e-6, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got["grad"], grad, rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", LEAF_CASES)
def test_leaf_collective_bytes_match_closed_form(runs, name):
    fwd, bwd = _leaf_closed_form(LEAF_CASES[name])
    for per_rank in runs["port"]["leaf"]:
        assert per_rank[name]["fwd"] == fwd and per_rank[name]["bwd"] == bwd
