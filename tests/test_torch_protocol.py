"""The port's protocol pieces of slice B against the JAX package on the
CPU: optimizers (AdamW, SGD, learning-rate schedules), convergence, the
phase vocabulary, staleness decay, round weights and mixing matrices, the
list and stacked eq. 14, and the baselines' cost model.

Every input is made from a seed with numpy and goes through both packages.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import convergence as jconv  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import protocol as jprotocol  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import convergence as tconv  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import protocol as tprotocol  # noqa: E402
from repro_torch.core import topology as ttopology  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.utils.tree import from_jax_params, to_numpy  # noqa: E402

CPU = torch.device("cpu")
# a few fp32 optimizer steps: the bias corrections' pow may round one ulp
# apart (torch.pow against XLA's), nothing else differs
OPT_TOL = dict(rtol=2e-6, atol=1e-8)


def _tree(rng):
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "sub": {"b": rng.standard_normal((5,)).astype(np.float32)}}


def _close(jtree, ttree, **tol):
    jt = jax.tree_util.tree_map(np.asarray, jtree)
    tt = to_numpy(ttree)
    jl, tl = jax.tree_util.tree_flatten_with_path(jt)[0], jax.tree_util.tree_flatten(tt)[0]
    assert len(jl) == len(tl)
    for (path, j), t in zip(jl, tl):
        np.testing.assert_allclose(t, j, err_msg=jax.tree_util.keystr(path), **tol)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adam": (lambda m: m.adam(3e-3)),
    "adamw": (lambda m: m.adamw(3e-3, weight_decay=0.05)),
    "adamw-clip": (lambda m: m.adamw(1e-2, grad_clip=0.5)),
    "sgd": (lambda m: m.sgd(0.1)),
    "sgd-momentum": (lambda m: m.sgd(0.05, momentum=0.9)),
    # a schedule: fp32 arithmetic of the int32 step, the same in jnp and torch
    "adam-schedule": (lambda m: m.adam(lambda s: 1e-2 / (1.0 + s))),
    "adamw-schedule": (lambda m: m.adamw(lambda s: 3e-3 * (1.0 - s / 8.0), weight_decay=0.1)),
    "sgd-schedule": (lambda m: m.sgd(lambda s: 0.2 / (s * s + 1.0), momentum=0.5)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_match_reference(name):
    rng = np.random.default_rng(3)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(6)]
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = from_jax_params(params, CPU)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = to.update(from_jax_params(g, CPU), ts, tp)
        _close(ju, tu, **OPT_TOL)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    _close(jp, tp, **OPT_TOL)
    assert int(js.step) == ts.step == len(grads)


def test_sgd_state_has_no_momentum_without_it():
    st = topt.sgd(0.1).init({"w": torch.zeros(2)})
    assert isinstance(st, topt.SGDState) and st.momentum is None and st.step == 0


# ---------------------------------------------------------------------------
# convergence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("losses,tol,patience", [
    ([1.0, 0.5, 0.4995, 0.4991], 1e-3, 2), ([1.0, 0.5, 0.4], 1e-3, 2),
    ([0.3], 1e-3, 2), ([2.0, 1.0, 0.9, 0.8, 0.79], 0.2, 3), ([], 1e-3, 1)])
def test_convergence_matches_reference(losses, tol, patience):
    assert (tconv.loss_delta_converged(losses, tol, patience)
            == jconv.loss_delta_converged(losses, tol, patience))
    if losses:
        assert tconv.aggregated_loss(losses) == jconv.aggregated_loss(losses)
    else:
        with pytest.raises(ValueError):
            tconv.aggregated_loss(losses)


# ---------------------------------------------------------------------------
# protocol vocabulary and staleness decay
# ---------------------------------------------------------------------------


def test_phases_and_method_phases_match_reference():
    assert [(p.name, p.value) for p in tprotocol.Phase] == \
        [(p.name, p.value) for p in jprotocol.Phase]
    assert [p.name for p in tprotocol.ROUND_PHASES] == [p.name for p in jprotocol.ROUND_PHASES]
    assert tprotocol.FLEET_METHODS == jprotocol.FLEET_METHODS
    for m in jprotocol.FLEET_METHODS:
        assert [p.name for p in tprotocol.method_phases(m)] == \
            [p.name for p in jprotocol.method_phases(m)]
    with pytest.raises(ValueError, match="unknown fleet method"):
        tprotocol.method_phases("fedprox")


@pytest.mark.parametrize("gamma", [0.5, 0.7, 0.8, 0.9, 1.0])
def test_decayed_round_weights_are_the_references_bits(gamma):
    """At the gammas the reference's tests use (0.5, 0.7, 0.8) and 0.9,
    1.0, over lags 0-64 under a 0/1 mask: bit for bit."""
    rng = np.random.default_rng(int(gamma * 10))
    lag = rng.integers(0, 65, size=(4, 65)).astype(np.int32)
    lag[0] = np.arange(65)
    w = (rng.random((4, 65)) < 0.8).astype(np.float32)
    want = np.asarray(jprotocol.decayed_round_weights(w, lag, gamma))
    got = tprotocol.decayed_round_weights(w, lag, gamma).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_decayed_round_weights_within_one_ulp_over_a_grid():
    """gamma on a 0.01 grid, lags 0-127: at most one ulp from ``jnp.power``
    (XLA is not always correctly rounded; fp64-then-round is), subnormal
    results flushed to zero as XLA does."""
    lag = np.arange(128, dtype=np.int32)
    w = np.ones_like(lag, np.float32)
    worst = 0
    for gamma in np.linspace(0.0, 1.0, 101):
        want = np.asarray(jprotocol.decayed_round_weights(w, lag, float(gamma)))
        got = tprotocol.decayed_round_weights(w, lag, float(gamma)).numpy()
        worst = max(worst, int(np.abs(got.view(np.int32).astype(np.int64)
                                      - want.view(np.int32).astype(np.int64)).max()))
    assert worst <= 1


# ---------------------------------------------------------------------------
# round weights and mixing matrices
# ---------------------------------------------------------------------------

STRATEGY_ARGS = [("cfl", 0), ("dfl_mesh", 0), ("dfl_ring", 0), ("enfed", 0), ("enfed", 2),
                 ("enfed", 3), ("none", 0)]


def _strategies(kind, k):
    return (jtopology.AggregationStrategy(kind=kind, neighborhood_size=k),
            ttopology.AggregationStrategy(kind=kind, neighborhood_size=k))


@pytest.mark.parametrize("kind,k", STRATEGY_ARGS)
def test_dynamic_round_weights_match_reference(kind, k):
    rng = np.random.default_rng(11)
    member = rng.random((3, 5, 6)) < 0.6
    rank = np.argsort(np.argsort(rng.random((3, 5, 6)), axis=-1), axis=-1).astype(np.int32)
    js, ts = _strategies(kind, k)
    for jstrat, tstrat in ((None, None), (js, ts)):
        want = np.asarray(jtopology.dynamic_round_weights(member, rank, jstrat))
        got = ttopology.dynamic_round_weights(member, rank, tstrat).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("kind,k", STRATEGY_ARGS)
def test_mixing_matrices_match_reference(kind, k):
    """``group_mixing_matrix`` bit for bit, and the tensor form equal to
    ``mixing_matrix_jnp``, for C = 1 ... 7 with and without masks (an
    all-zero mask included)."""
    js, ts = _strategies(kind, k)
    rng = np.random.default_rng(5)
    for c in range(1, 8):
        masks = [None, np.zeros(c, np.float32), (rng.random(c) < 0.5).astype(np.float32),
                 (rng.random(c) < 0.8).astype(np.float32)]
        for mask in masks:
            want = jtopology.group_mixing_matrix(c, js, mask)
            got = ttopology.group_mixing_matrix(c, ts, mask)
            assert got.dtype == np.float32 and np.array_equal(got, want), (c, mask)
            want_t = np.asarray(jtopology.mixing_matrix_jnp(c, js, mask))
            got_t = ttopology.mixing_matrix_torch(
                c, ts, None if mask is None else torch.from_numpy(mask)).numpy()
            np.testing.assert_array_equal(got_t, want_t, err_msg=f"C={c} mask={mask}")


def test_apply_mixing_matches_reference():
    rng = np.random.default_rng(2)
    stacked = {"w": rng.standard_normal((5, 3, 4)).astype(np.float32),
               "sub": {"b": rng.standard_normal((5, 7)).astype(np.float32)}}
    js, ts = _strategies("dfl_ring", 0)
    M = jtopology.group_mixing_matrix(5, js)
    want = jtopology.apply_mixing(jax.tree_util.tree_map(jnp.asarray, stacked), M)
    got = ttopology.apply_mixing(from_jax_params(stacked, CPU), torch.from_numpy(M))
    _close(want, got, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


def test_list_and_stacked_fedavg_match_reference():
    rng = np.random.default_rng(9)
    trees = [_tree(rng) for _ in range(4)]
    jtrees = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]
    ttrees = [from_jax_params(t, CPU) for t in trees]
    sizes = [120.0, 37.0, 1.0, 64.0]
    mask = [1.0, 0.0, 1.0, 1.0]
    _close(jagg.fedavg(jtrees), tagg.fedavg(ttrees), rtol=1e-6, atol=1e-7)
    _close(jagg.fedavg(jtrees, sizes), tagg.fedavg(ttrees, sizes), rtol=1e-6, atol=1e-7)
    _close(jagg.masked_fedavg(jtrees, mask, sizes), tagg.masked_fedavg(ttrees, mask, sizes),
           rtol=1e-6, atol=1e-7)
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)
    for w in (None, sizes):
        _close(jagg.masked_weighted_mean_stacked(
                   jax.tree_util.tree_map(jnp.asarray, stacked), mask, w),
               tagg.masked_weighted_mean_stacked(from_jax_params(stacked, CPU), mask, w),
               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="at least one update"):
        tagg.fedavg([])


def test_delta_and_apply_delta_match_reference():
    rng = np.random.default_rng(4)
    a, b = _tree(rng), _tree(rng)
    ja, jb = (jax.tree_util.tree_map(jnp.asarray, t) for t in (a, b))
    ta, tb = from_jax_params(a, CPU), from_jax_params(b, CPU)
    jd, td = jagg.delta(ja, jb), tagg.delta(ta, tb)
    _close(jd, td, rtol=0, atol=0)
    _close(jagg.apply_delta(jb, jd, 0.5), tagg.apply_delta(tb, td, 0.5), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the baselines' cost model
# ---------------------------------------------------------------------------


def _report_fields(rep):
    t = rep.times
    return (t.t_dev, t.t_hand, t.t_key, t.t_init, t.t_com, t.t_enc, t.t_dec, t.t_agg,
            t.t_loc, rep.e_comp, rep.e_comm, rep.e_tot, rep.t_train)


@pytest.mark.parametrize("rounds,model_bytes,measured", [
    (1, 74_264, None), (7, 19_456 + 76, 3.25), (10, 1_234, 0.0), (0, 74_264, None)])
def test_baseline_cost_methods_match_reference_to_the_float(rounds, model_bytes, measured):
    jc, tc = jenergy.CostModel(), tenergy.CostModel()
    common = dict(rounds=rounds, num_params=18_566, model_bytes=model_bytes,
                  num_samples=412, epochs=8, measured_local_time=measured)
    assert _report_fields(tc.cfl_session(**common)) == _report_fields(jc.cfl_session(**common))
    for topo in ("mesh", "ring"):
        for peers in (1, 2, 5):
            kw = dict(common, n_peers=peers, topology=topo)
            assert _report_fields(tc.dfl_session(**kw)) == _report_fields(jc.dfl_session(**kw))
    kw = dict(data_bytes=model_bytes * 31, cloud_train_s=measured or 1.5)
    assert _report_fields(tc.cloud_session(**kw)) == _report_fields(jc.cloud_session(**kw))
    kw = dict(data_bytes=model_bytes * 31, num_params=18_566, num_samples=9_000, epochs=8)
    assert tc.cloud_only_response(**kw) == jc.cloud_only_response(**kw)
    assert (tc.cloud_only_response(**kw, cloud_flops=1e12)
            == jc.cloud_only_response(**kw, cloud_flops=1e12))
