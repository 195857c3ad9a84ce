"""The port's client-sharded federated train step on 8 gloo ranks of this
CPU against the reference's on 8 fake host devices: the tier-1 twin of
``tests/test_distributed.py::test_federated_train_step_all_strategies``.

One federated step of ``debug-moe`` at its registered widths on
(2, 2, 2), from the reference's weights and one seeded batch of 8 x 16
tokens, for every strategy and for ``"none"`` (plain data parallel over
(pod, data), whose token-local MoE routes each data shard gathered over
``pod``): losses within ``LOSS_ATOL``, params by the rule of
``tests/test_torch_fed_trainer.py`` (max gap within two Adam steps, few
elements beyond ``FAR``); the four strategies' losses agree within 1e-4,
the reference's assertion.  The reference runs in one subprocess while
the port's ranks run."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import _torch_mesh_ranks as ranks  # noqa: E402

LOSS_ATOL = 5e-6
LR = 1e-3
PARAM_ATOL = 2 * LR
FAR, FAR_SHARE = 1e-5, 1e-4
KINDS = ("cfl", "enfed", "dfl_ring", "dfl_mesh")

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
from repro.sharding import use_mesh

tr = pickle.load(open(sys.argv[1], "rb"))
out = {}
mesh = make_debug_mesh(multi_pod=True)
cfg = get_config(tr["arch"])
model = Transformer(cfg)
caxes = client_axes_for(cfg, mesh)
C = num_clients(mesh, caxes)
params = jax.tree_util.tree_map(jnp.asarray, tr["params"])
batch = {k: jnp.asarray(v, jnp.int32) for k, v in tr["batch"].items()}
mask = jnp.asarray(tr["mask"])
for kind in tr["kinds"]:
    strat = AggregationStrategy(kind=kind, client_axes=caxes, neighborhood_size=2)
    with use_mesh(mesh):
        step, opt = make_federated_train_step(model, mesh, strat, lr=tr["lr"])
        if kind == "none":
            p2, _, loss = jax.jit(step)(params, opt.init(params), batch, mask)
        else:
            pf = stack_for_clients(params, C)
            of = stack_for_clients(opt.init(params), C)
            psh = fed_param_shardings(jax.eval_shape(lambda: pf), mesh, caxes, cfg.fsdp)
            bsh = batch_input_shardings(batch, mesh, client_stacked=True, client_axes=caxes)
            p2, _, loss = jax.jit(step, in_shardings=(psh, None, bsh, None))(pf, of, batch, mask)
    out[kind] = dict(loss=float(loss), params=jax.tree_util.tree_map(np.asarray, p2))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs():
    from repro.configs import get_config
    from repro.models import Transformer as JTransformer

    rng = np.random.default_rng(27)
    cfg = get_config("debug-moe")
    params = jax.tree_util.tree_map(np.asarray, JTransformer(cfg).init(jax.random.PRNGKey(0)))
    toks = rng.integers(0, cfg.vocab_size, (8, 17))
    train = dict(arch="debug-moe", params=params, lr=LR,
                 batch={"tokens": toks[:, :-1].astype(np.int64),
                        "labels": toks[:, 1:].astype(np.int64)},
                 mask=np.ones(4, np.float32), kinds=KINDS + ("none",))
    ref, per_rank = ranks.run_with_reference(_REFERENCE, train, ranks.train_steps)
    return dict(ref=ref, port=per_rank[0])


@pytest.mark.parametrize("kind", KINDS + ("none",))
def test_federated_train_step_matches_the_reference(runs, kind):
    got, want = runs["port"][kind], runs["ref"][kind]
    assert abs(got["loss"] - want["loss"]) <= LOSS_ATOL, (got["loss"], want["loss"])
    total = far = 0
    g_items, w_items = dict(ranks.tree_items(got["params"])), dict(ranks.tree_items(want["params"]))
    assert set(g_items) == set(w_items)
    for path, w in w_items.items():
        g = g_items[path]
        assert g.shape == w.shape, path
        gap = np.abs(g - w)
        assert gap.max() <= PARAM_ATOL, (path, gap.max())
        total += gap.size
        far += int((gap > FAR).sum())
    assert far <= FAR_SHARE * total, f"{far} of {total} elements beyond {FAR}"


def test_federated_train_step_all_strategies_twin(runs):
    """Same data, same init: the same loss under every aggregation kind."""
    vals = [runs["port"][k]["loss"] for k in KINDS]
    assert all(np.isfinite(vals)) and max(vals) - min(vals) < 1e-4, vals
