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
  and the gradient of ``sum(y * r) + aux`` within ``MOE_TOL``.

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
    data = dict(cases=CASES, updates=updates, masks=masks, moe=moe_data)
    ref, per_rank = ranks.run_with_reference(_REFERENCE, data, ranks.agg_and_moe)
    return dict(ref=ref, port=dict(agg=per_rank[0]["agg"], moe=[r["moe"] for r in per_rank]),
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
    want = runs["ref"]["moe"][(multi, dispatch)]
    per_rank = [r[(multi, dispatch)] for r in runs["port"]["moe"]]
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
        ep, srt = runs["port"]["moe"][0][(multi, "ep")], runs["port"]["moe"][0][(multi, "sort")]
        np.testing.assert_allclose(ep["y"], srt["y"], **MOE_TOL)
        assert abs(ep["aux"] - srt["aux"]) <= 1e-6
