"""The port's models, loss, optimizer, supervised task, trees and data
against the JAX package, on converted weights (CPU)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import SupervisedTask as JTask  # noqa: E402
from repro.data import HARDatasetConfig as JHARConfig  # noqa: E402
from repro.data import dirichlet_partition as jpartition  # noqa: E402
from repro.data import make_calories_tabular as jcalories  # noqa: E402
from repro.data import make_har_windows as jwindows  # noqa: E402
from repro.models import LSTMClassifier as JLSTM  # noqa: E402
from repro.models import LSTMClassifierConfig as JLSTMConfig  # noqa: E402
from repro.models import MLPClassifier as JMLP  # noqa: E402
from repro.models import MLPClassifierConfig as JMLPConfig  # noqa: E402
from repro.models.classifiers import masked_cross_entropy_loss as jmasked_ce  # noqa: E402
from repro.utils.tree import flatten_to_vector as jflatten  # noqa: E402
from repro_torch.core.federated import SupervisedTask  # noqa: E402
from repro_torch.data import (HARDatasetConfig, dirichlet_partition,  # noqa: E402
                              make_calories_tabular, make_har_windows)
from repro.utils.tree import tree_ravel as jravel  # noqa: E402
from repro_torch.kernels.lstm_cell import ops as lstm_ops  # noqa: E402
from repro_torch.models import (LSTMClassifier, LSTMClassifierConfig,  # noqa: E402
                                MLPClassifier, MLPClassifierConfig,
                                masked_cross_entropy_loss)
from repro_torch.optim import lane_adam_init, lane_adam_step  # noqa: E402
from repro_torch.utils.tree import (flatten_to_vector, from_jax_params,  # noqa: E402
                                    to_numpy, tree_bytes, tree_leaves, tree_map,
                                    tree_ravel, tree_size, tree_unravel,
                                    tree_weighted_mean, tree_where,
                                    unflatten_from_vector)

CPU = torch.device("cpu")
# fp32 forward/backward in another summation order than XLA
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
# a few Adam steps amplify fp32 rounding where gradients are near zero
FIT_TOL = dict(rtol=1e-4, atol=2e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(jtree, ttree, **tol):
    jt, tt = _np_tree(jtree), to_numpy(ttree)
    assert set(jt) == set(tt)
    for k in jt:
        if isinstance(jt[k], dict):
            _assert_trees_close(jt[k], ttree[k], **tol)
        else:
            np.testing.assert_allclose(tt[k], jt[k], err_msg=k, **tol)


def _lstm_pair(hidden=16, seq_len=8):
    jm = JLSTM(JLSTMConfig(input_dim=6, seq_len=seq_len, hidden=hidden, num_classes=6))
    tm = LSTMClassifier(LSTMClassifierConfig(input_dim=6, seq_len=seq_len, hidden=hidden),
                        device=CPU)
    return jm, tm


def _mlp_pair(hidden=(16, 8)):
    jm = JMLP(JMLPConfig(input_dim=8, hidden=hidden, num_classes=5))
    tm = MLPClassifier(MLPClassifierConfig(input_dim=8, hidden=hidden), device=CPU)
    return jm, tm


def _batch(kind, b, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "lstm":
        x = rng.standard_normal((b, 8, 6)).astype(np.float32)
        y = rng.integers(0, 6, b).astype(np.int32)
    else:
        x = rng.standard_normal((b, 8)).astype(np.float32)
        y = rng.integers(0, 5, b).astype(np.int32)
    return x, y


PAIRS = {"lstm": _lstm_pair, "mlp": _mlp_pair}


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["lstm", "mlp"])
def test_forward_matches_jax_on_converted_weights(kind):
    jm, tm = PAIRS[kind]()
    jp = jm.init(jax.random.PRNGKey(3))
    x, _ = _batch(kind, 12)
    want = np.asarray(jm.forward(jp, jnp.asarray(x)))
    got = tm.logits(from_jax_params(_np_tree(jp), CPU), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("kind", ["lstm", "mlp"])
def test_module_parameters_carry_the_jax_names(kind):
    jm, tm = PAIRS[kind]()
    jp = jm.init(jax.random.PRNGKey(0))
    jnames = {"/".join(str(k.key) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tnames = {n.replace(".", "/") for n, _ in tm.named_parameters()}
    assert jnames == tnames
    init = tm.init(torch.Generator().manual_seed(0))
    assert tree_size(init) == sum(int(np.size(v)) for v in jax.tree_util.tree_leaves(jp))


@pytest.mark.parametrize("kind", ["lstm", "mlp"])
def test_module_forward_equals_functional_logits(kind):
    _, tm = PAIRS[kind]()
    params = tm.init(torch.Generator().manual_seed(1))
    with torch.no_grad():
        for name, p in tm.named_parameters():
            node = params
            for key in name.split("."):
                node = node[key]
            p.copy_(node)
    x, _ = _batch(kind, 5)
    xt = torch.from_numpy(x)
    torch.testing.assert_close(tm(xt), tm.logits(params, xt))


def test_model_without_device_raises_on_a_host_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LSTMClassifier(LSTMClassifierConfig(input_dim=6, seq_len=8, hidden=8))


@pytest.mark.parametrize("kind", ["lstm", "mlp"])
def test_masked_loss_and_grads_match_jax(kind):
    jm, tm = PAIRS[kind]()
    jp = jm.init(jax.random.PRNGKey(5))
    x, y = _batch(kind, 16, seed=2)
    w = np.ones(16, np.float32)
    w[11:] = 0.0                            # padded tail of a sub-batch shard

    def jloss(p):
        return jmasked_ce(jm.forward(p, jnp.asarray(x)), jnp.asarray(y), jnp.asarray(w))

    jl, jg = jax.value_and_grad(jloss)(jp)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True),
                                _np_tree(jp))
    tl = masked_cross_entropy_loss(tm.logits(tp, torch.from_numpy(x)),
                                   torch.from_numpy(y), torch.from_numpy(w))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **FWD_TOL)
    grads = jax.tree_util.tree_map(lambda t: t.grad, tp)
    _assert_trees_close(jg, grads, **FWD_TOL)


def test_masked_loss_all_zero_weights_is_zero():
    logits, labels = torch.randn(4, 3), torch.tensor([0, 1, 2, 0])
    assert float(masked_cross_entropy_loss(logits, labels, torch.zeros(4))) == 0.0


# ---------------------------------------------------------------------------
# optimizer and supervised task
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["lstm", "mlp"])
def test_one_adam_step_matches_jax(kind):
    jm, tm = PAIRS[kind]()
    jt, tt = JTask(jm, lr=3e-3), SupervisedTask(tm, lr=3e-3)
    jp = jt.init(seed=4)
    x, y = _batch(kind, 16, seed=3)
    w = np.ones(16, np.float32)
    jp2, jopt, jl = jt._step(jp, jt._opt.init(jp), jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(w))
    tp = from_jax_params(_np_tree(jp), CPU)
    tp2, topt, tl = tt._step(tp, tt._opt.init(tp), torch.from_numpy(x),
                             torch.from_numpy(y).long(), torch.from_numpy(w))
    np.testing.assert_allclose(float(tl), float(jl), **FWD_TOL)
    _assert_trees_close(jp2, tp2, **FWD_TOL)
    _assert_trees_close(jopt.mu, topt.mu, **FWD_TOL)
    _assert_trees_close(jopt.nu, topt.nu, rtol=1e-4, atol=1e-10)
    assert topt.step == int(jopt.step) == 1


@pytest.mark.parametrize("kind", ["lstm", "mlp"])
@pytest.mark.parametrize("partitionable", [True, False])
def test_fit_two_epochs_matches_jax(kind, partitionable):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        jm, tm = PAIRS[kind]()
        jt = JTask(jm, lr=3e-3)
        tt = SupervisedTask(tm, lr=3e-3, threefry_partitionable=partitionable)
        jp = jt.init(seed=6)
        x, y = _batch(kind, 45, seed=4)
        jfit, jlosses = jt.fit(jp, (x, y), epochs=2, batch_size=16, seed=9)
        tfit, tlosses = tt.fit(from_jax_params(_np_tree(jp), CPU), (x, y), epochs=2,
                               batch_size=16, seed=9)
        np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
        _assert_trees_close(jfit, tfit, **FIT_TOL)
        assert tt.evaluate(tfit, (x, y)) == pytest.approx(jt.evaluate(jfit, (x, y)))
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def test_fit_on_a_sub_batch_shard_runs_one_padded_step():
    jm, tm = _mlp_pair()
    jt, tt = JTask(jm, lr=1e-2), SupervisedTask(tm, lr=1e-2)
    jp = jt.init(seed=1)
    x, y = _batch("mlp", 5, seed=5)
    jfit, jl = jt.fit(jp, (x, y), epochs=2, batch_size=16, seed=2)
    tfit, tl = tt.fit(from_jax_params(_np_tree(jp), CPU), (x, y), epochs=2,
                      batch_size=16, seed=2)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_trees_close(jfit, tfit, **FIT_TOL)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def test_flatten_follows_jax_leaf_order_with_many_layers():
    """layer10 sorts before layer2, and LSTM keys flatten b, b_out, w_out,
    wh, wx, exactly as jax's tree_flatten."""
    jm, tm = _mlp_pair(hidden=(3,) * 10)          # layer0 .. layer10
    jp = jm.init(jax.random.PRNGKey(2))
    want = np.asarray(jflatten(jp)[0])
    vec, unflatten = flatten_to_vector(from_jax_params(_np_tree(jp), CPU))
    assert np.array_equal(vec.numpy(), want)
    back = unflatten(vec)
    _assert_trees_close(jp, back, rtol=0, atol=0)
    jm, _ = _lstm_pair()
    jp = jm.init(jax.random.PRNGKey(2))
    tp = from_jax_params(_np_tree(jp), CPU)
    assert np.array_equal(flatten_to_vector(tp)[0].numpy(), np.asarray(jflatten(jp)[0]))
    assert tree_bytes(tp) == 4 * tree_size(tp)


def test_unflatten_tree_where_and_weighted_mean():
    a = {"w": torch.ones(2, 3), "b": {"x": torch.zeros(4)}}
    b = {"w": torch.full((2, 3), 3.0), "b": {"x": torch.full((4,), 2.0)}}
    vec = flatten_to_vector(b)[0]
    assert torch.equal(unflatten_from_vector(vec, a)["w"], b["w"])
    assert torch.equal(tree_where(torch.tensor(True), a, b)["w"], a["w"])
    assert torch.equal(tree_where(torch.tensor(False), a, b)["b"]["x"], b["b"]["x"])
    mean = tree_weighted_mean([a, b], [1.0, 3.0])
    torch.testing.assert_close(mean["w"], torch.full((2, 3), 2.5))
    torch.testing.assert_close(mean["b"]["x"], torch.full((4,), 1.5))


def test_tree_ravel_matches_jax_and_unravel_returns_views():
    jm, _ = _mlp_pair(hidden=(3,) * 10)               # layer10 sorts before layer2
    trees = [jm.init(jax.random.PRNGKey(i)) for i in range(6)]
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs).reshape((2, 3) + xs[0].shape),
                                     *[_np_tree(t) for t in trees])
    jflat, _ = jravel(stacked, batch_ndim=2)
    flat, spec = tree_ravel(from_jax_params(stacked, CPU), batch_ndim=2)
    assert np.array_equal(flat.numpy(), np.asarray(jflat))
    back = tree_unravel(spec, flat)
    _assert_trees_close(stacked, back, rtol=0, atol=0)
    for leaf in tree_leaves(back):
        assert leaf.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
    # autograd through the views gives the flat gradient
    lanes = flat.reshape(6, -1).clone().requires_grad_(True)
    total = sum((leaf * leaf).sum() for leaf in tree_leaves(tree_unravel(spec, lanes)))
    total.backward()
    torch.testing.assert_close(lanes.grad, 2 * lanes.detach())


def _lane_stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


@pytest.mark.parametrize("kind", ["lstm", "mlp"])
def test_lane_logits_loss_and_grads_equal_single_lane_calls(kind):
    _, tm = PAIRS[kind]()
    lanes = 3
    params = [tm.init(torch.Generator().manual_seed(20 + i)) for i in range(lanes)]
    batches = [_batch(kind, 9, seed=30 + i) for i in range(lanes)]
    x = torch.from_numpy(np.stack([b[0] for b in batches]))
    y = torch.from_numpy(np.stack([b[1] for b in batches]))
    w = torch.ones(lanes, 9)
    w[1, 5:] = 0.0
    flat, spec = tree_ravel(_lane_stack(params), batch_ndim=1)
    flat.requires_grad_(True)
    logits = tm.lane_logits(tree_unravel(spec, flat), x)
    losses = masked_cross_entropy_loss(logits, y, w)
    (grad,) = torch.autograd.grad(losses.sum(), flat)
    for i in range(lanes):
        p = tree_map(lambda t: t.clone().requires_grad_(True), params[i])
        li = tm.logits(p, x[i])
        torch.testing.assert_close(logits[i].detach(), li.detach(), **FWD_TOL)
        loss = masked_cross_entropy_loss(li, y[i], w[i])
        torch.testing.assert_close(losses[i].detach(), loss.detach(), **FWD_TOL)
        gi = torch.autograd.grad(loss, tree_leaves(p))
        torch.testing.assert_close(grad[i], torch.cat([g.reshape(-1) for g in gi]), **FWD_TOL)


def test_lane_cell_backward_equals_single_lane_backward():
    rng = np.random.default_rng(4)
    shapes = [(3, 5, 4), (3, 5, 6), (3, 5, 6), (3, 4, 24), (3, 6, 24), (3, 24)]
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.5) for s in shapes]
    lane = [a.clone().requires_grad_(True) for a in args]
    hn, cn = lstm_ops.lstm_cell_autograd(*lane)
    (hn.sum() + 2 * cn.sum()).backward()
    for i in range(3):
        one = [a[i].clone().requires_grad_(True) for a in args]
        h1, c1 = lstm_ops.lstm_cell_autograd(*one)
        (h1.sum() + 2 * c1.sum()).backward()
        for name, a, b in zip(("x", "h", "c", "wx", "wh", "b"), lane, one):
            torch.testing.assert_close(a.grad[i], b.grad, **FWD_TOL, msg=name)


def test_lane_adam_equals_tree_adam_and_skips_idle_lanes():
    _, tm = _mlp_pair()
    tt = SupervisedTask(tm, lr=3e-3)
    params = [tm.init(torch.Generator().manual_seed(i)) for i in range(2)]
    grads = [tm.init(torch.Generator().manual_seed(10 + i)) for i in range(2)]
    flat, spec = tree_ravel(_lane_stack(params), batch_ndim=1)
    gflat, _ = tree_ravel(_lane_stack(grads), batch_ndim=1)
    state = lane_adam_init(flat)
    take = torch.tensor([True, False])
    for _ in range(2):
        flat, state = lane_adam_step(flat, gflat, state, take, 3e-3)
    assert state.step.tolist() == [2, 0]
    torch.testing.assert_close(flat[1], tree_ravel(params[1])[0], rtol=0, atol=0)
    assert not state.mu[1].any()
    opt_state = tt._opt.init(params[0])
    p0 = params[0]
    for _ in range(2):
        upd, opt_state = tt._opt.update(grads[0], opt_state, p0)
        p0 = tree_map(torch.add, p0, upd)
    torch.testing.assert_close(flat[0], tree_ravel(p0)[0], rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# data copies
# ---------------------------------------------------------------------------


def test_data_copies_produce_the_same_arrays():
    cfg = dict(num_samples=300, seq_len=8)
    for a, b in zip(jwindows(JHARConfig(**cfg)), make_har_windows(HARDatasetConfig(**cfg))):
        assert np.array_equal(a, b)
    for a, b in zip(jcalories(), make_calories_tabular()):
        assert np.array_equal(a, b)
    y = make_har_windows(HARDatasetConfig(**cfg))[1]
    for a, b in zip(jpartition(y, num_clients=6, alpha=1.0, seed=0),
                    dirichlet_partition(y, num_clients=6, alpha=1.0, seed=0)):
        assert np.array_equal(a, b)
