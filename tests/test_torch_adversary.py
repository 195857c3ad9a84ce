"""The Byzantine-contributor world of the port against the JAX package on
the CPU: the adversary's draws and attacks, and both engines on the
static worlds of ``tests/test_adversary.py`` (their fault, cadence and
mobility parts belong to later slices of the port).

Rounds, stop reasons and the corrupted and clipped masks must match
exactly; params, battery and the screening-priced report fields allclose.
Each world runs once per module through the JAX loop engine, the JAX fleet
and the port's two engines (the results are cached by case).
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import adversary as jadv  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import adversary as tadv  # noqa: E402
from repro_torch.core.battery import BatteryState  # noqa: E402
from repro_torch.kernels.quantize.ref import quantize_batched_ref  # noqa: E402
from repro_torch.models import MLPClassifier, MLPClassifierConfig  # noqa: E402
from repro_torch.utils.tree import flatten_to_vector, from_jax_params  # noqa: E402

from test_fleet_engine import BATCH, _build  # noqa: E402

CPU = torch.device("cpu")
# four rounds of Adam fits and refreshes: fp32 rounding in another order
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
# int8: the per-tile scale bound of tests/test_compress.py
INT8_TOL = dict(rtol=0, atol=1e-2)
# the dense noise payload goes through torch.erfinv, XLA's erf_inv differs
# from it by a few ulps in the tails
NOISE_TOL = dict(rtol=2e-5, atol=1e-6)
# the fleet discharges the battery in fp32 (the loop engine in float64)
BATTERY_RTOL = 1e-6


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def threefry_mode(request):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)


def _pair(**kw):
    return jadv.AdversaryConfig(**kw), tadv.AdversaryConfig(**kw)


IDS = np.array([[3, 9, 12, 40, 7, 1], [3, 4, 5, 0, 2, 11]], np.int64)
REQ = np.array([1 << 23, (1 << 23) + 1], np.int64)


# ---------------------------------------------------------------------------
# the adversary's functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(p_byzantine=-0.1), dict(p_byzantine=1.5),
                                dict(attack="gradient_ascent"), dict(scale=0.0)])
def test_adversary_config_validation(kw):
    with pytest.raises(ValueError):
        tadv.AdversaryConfig(**kw)


@pytest.mark.parametrize("p", [0.0, 0.3, 0.5, 1.0])
def test_corruption_mask_matches_jax(p, threefry_mode):
    jac, tac = _pair(p_byzantine=p, seed=9)
    for r in (0, 1, 5):
        want = np.asarray(jadv.corruption_mask(jac, r, REQ.astype(np.int32),
                                               IDS.astype(np.int32)))
        got = tadv.corruption_mask(tac, r, torch.from_numpy(REQ), torch.from_numpy(IDS),
                                   partitionable=threefry_mode)
        assert np.array_equal(got.numpy(), want)
        want1 = np.asarray(jadv.corruption_mask(jac, r, 1 << 23, IDS[0].astype(np.int32)))
        assert np.array_equal(tadv.corruption_mask(tac, r, 1 << 23, IDS[0],
                                                   partitionable=threefry_mode).numpy(), want1)


def test_corruption_mask_splits_links_and_depends_on_round_and_requester():
    tac = tadv.AdversaryConfig(p_byzantine=0.5, seed=9)
    ids = torch.arange(64)
    m = tadv.corruption_mask(tac, 4, tac.requester_id, ids)
    assert 0 < int(m.sum()) < 64
    assert not torch.equal(m, tadv.corruption_mask(tac, 5, tac.requester_id, ids))
    assert not torch.equal(m, tadv.corruption_mask(tac, 4, tac.requester_id + 1, ids))


@pytest.mark.parametrize("length", [1, 1024, 2048 + 5])
def test_noise_codes_match_jax_exactly(length, threefry_mode):
    jac, tac = _pair(p_byzantine=1.0, attack="noise", scale=3.0, seed=7)
    want = np.asarray(jadv.noise_codes(jac, 2, 1 << 23, 11, length))
    got = tadv.noise_codes(tac, 2, 1 << 23, 11, length, partitionable=threefry_mode)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    assert tadv.noise_scale(tac) == float(jadv.noise_scale(jac))


@pytest.mark.parametrize("length", [1, 300, 4097])
def test_noise_vector_matches_jax(length, threefry_mode):
    jac, tac = _pair(p_byzantine=1.0, attack="noise", scale=2.0, seed=7)
    want = np.asarray(jadv.noise_vector(jac, 3, 1 << 23, 5, length))
    got = tadv.noise_vector(tac, 3, 1 << 23, 5, length, partitionable=threefry_mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **NOISE_TOL)


@pytest.mark.parametrize("attack", tadv.ATTACKS)
def test_corrupt_dense_and_wire_match_jax(attack, threefry_mode):
    jac, tac = _pair(p_byzantine=0.5, attack=attack, scale=3.0, seed=7)
    rng = np.random.default_rng(0)
    u = rng.normal(size=(2, 6, 300)).astype(np.float32)
    c = np.array([[1, 0, 1, 1, 0, 0], [0, 1, 0, 1, 1, 0]], bool)
    exact = {} if attack == "noise" else dict(rtol=0, atol=0)
    want = np.asarray(jadv.corrupt_dense_batched(jac, u, c, 2, REQ.astype(np.int32),
                                                 IDS.astype(np.int32)))
    tu = torch.from_numpy(u)
    got = tadv.corrupt_dense_batched(tac, tu, torch.from_numpy(c), 2, REQ, IDS,
                                     partitionable=threefry_mode)
    np.testing.assert_allclose(got.numpy(), want, **(exact or NOISE_TOL))
    assert torch.equal(tu, torch.from_numpy(u))              # the input stays put
    one = tadv.corrupt_dense(tac, tu[0, 0], True, 2, int(REQ[0]), int(IDS[0, 0]),
                             partitionable=threefry_mode)
    assert torch.equal(one, got[0, 0])                       # batched == per link
    honest = tu[0, 1]
    assert tadv.corrupt_dense(tac, honest, False, 2, 0, 0) is honest

    q, s = quantize_batched_ref(tu.reshape(12, 300))
    q, s = q.reshape(2, 6, -1), s.reshape(2, 6, -1)
    jq, js = jadv.corrupt_wire_batched(jac, q.numpy(), s.numpy(), c, 2,
                                       REQ.astype(np.int32), IDS.astype(np.int32))
    gq, gs = tadv.corrupt_wire_batched(tac, q, s, torch.from_numpy(c), 2, REQ, IDS,
                                       partitionable=threefry_mode)
    assert gq.dtype == torch.int8
    assert np.array_equal(gq.numpy(), np.asarray(jq))
    assert np.array_equal(gs.numpy(), np.asarray(js))
    oq, os_ = tadv.corrupt_wire(tac, q[1, 1], s[1, 1], True, 2, int(REQ[1]), int(IDS[1, 1]),
                                partitionable=threefry_mode)
    assert torch.equal(oq, gq[1, 1]) and torch.equal(os_, gs[1, 1])


# ---------------------------------------------------------------------------
# both engines against the JAX package
# ---------------------------------------------------------------------------

AC = dict(p_byzantine=0.5, attack="signflip", seed=7)
WORLDS = {
    # name: (adversary kwargs, config overrides, threefry partitionable)
    "signflip-trim": (AC, dict(robust="trimmed_mean"), True),
    "scale-median": (dict(p_byzantine=0.5, attack="scale", scale=5.0, seed=7),
                     dict(robust="median"), True),
    "zero-trim-int8": (dict(p_byzantine=0.5, attack="zero", seed=7),
                       dict(robust="trimmed_mean", compress="int8"), True),
    "signflip-clip-encrypt": (AC, dict(robust="clip", encrypt=True), True),
    "noise-clip": (dict(p_byzantine=0.5, attack="noise", scale=2.0, seed=7),
                   dict(robust="clip"), True),
    "noise-clip-int8": (dict(p_byzantine=0.5, attack="noise", scale=2.0, seed=7),
                        dict(robust="clip", compress="int8"), False),
    "clip-actually-clips": (dict(p_byzantine=0.5, attack="scale", scale=50.0, seed=7),
                            dict(robust="clip"), True),
}

_PROBLEM = {}
_RUNS = {}


def _problem():
    if not _PROBLEM:
        _PROBLEM["jax"] = _build()
    return _PROBLEM["jax"]


def _cfg(mod, adversary, **kw):
    base = dict(desired_accuracy=0.99, max_rounds=4, epochs=1, batch_size=BATCH,
                encrypt=False, contributor_refresh_epochs=1)
    base.update(kw)
    return mod.EnFedConfig(adversary=adversary, **base)


def _port_world(partitionable):
    task, own_train, own_test, fleet, states = _problem()
    ttask = tcore.SupervisedTask(MLPClassifier(MLPClassifierConfig(8, (16,), 5), device=CPU),
                                 lr=3e-3, threefry_partitionable=partitionable)
    tfleet = tcore.make_fleet(len(fleet), seed=1, p_has_model=1.0)
    for d in tfleet:
        d.reservation_price = 0.4

    def states_fn():
        return {did: {"params": from_jax_params(jax.tree_util.tree_map(np.asarray, st["params"]),
                                                CPU),
                      "data": st["data"]} for did, st in states.items()}
    return ttask, own_train, own_test, tfleet, states_fn


def _run_port(partitionable, cfg):
    ttask, own_train, own_test, tfleet, states_fn = _port_world(partitionable)
    loop = tcore.EnFedSession(ttask, own_train, own_test, tfleet, states_fn(), cfg,
                              battery=BatteryState(), device=CPU).run()
    spec = tcore.RequesterSpec(own_train, own_test, tfleet, states_fn(), BatteryState())
    return loop, tcore.run_fleet(ttask, [spec], cfg, device=CPU).sessions[0]


def _run_world(name):
    if name in _RUNS:
        return _RUNS[name]
    akw, over, part = WORLDS[name]
    task, own_train, own_test, fleet, states = _problem()
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", part)
    try:
        jcfg = _cfg(jcore, jadv.AdversaryConfig(**akw), **over)
        jloop = jcore.EnFedSession(task, own_train, own_test, fleet, copy.deepcopy(states),
                                   jcfg, battery=jcore.BatteryState()).run()
        spec = jcore.RequesterSpec(own_train, own_test, fleet, copy.deepcopy(states),
                                   jcore.BatteryState())
        jfleet = jcore.run_fleet(task, [spec], jcfg).sessions[0]
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    tloop, tfleet = _run_port(part, _cfg(tcore, tadv.AdversaryConfig(**akw), **over))
    _RUNS[name] = (jloop, jfleet, tloop, tfleet)
    return _RUNS[name]


def _masks(res, key, n=None):
    m = np.stack(res.history_raw[key])
    return m if n is None else m[:, :n]


def _assert_matches(ref, port, *, robust, int8, battery_rtol):
    assert (port.rounds, port.stop_reason, port.n_contributors, port.model_bytes) == \
        (ref.rounds, ref.stop_reason, ref.n_contributors, ref.model_bytes)
    n = len(ref.history_raw["corrupted_mask"][0])
    for key in ("corrupted_mask", "clipped_mask") if robust == "clip" else ("corrupted_mask",):
        pm, rm = _masks(port, key), _masks(ref, key)
        assert np.array_equal(pm[:, :n], rm[:, :n]), key
        assert not pm[:, n:].any() and not rm[:, n:].any(), f"{key}: padded lanes flagged"
    if robust != "clip":
        assert not _masks(port, "clipped_mask").any()
    np.testing.assert_allclose(port.history_raw["accuracy"], ref.history_raw["accuracy"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.history_raw["battery"], ref.history_raw["battery"],
                               rtol=battery_rtol)
    pv = flatten_to_vector(port.params)[0].numpy()
    rv = np.asarray(jax.flatten_util.ravel_pytree(ref.params)[0])
    np.testing.assert_allclose(pv, rv, **(INT8_TOL if int8 else PARAM_TOL))
    # screening is priced into t_agg / e_comp per executed round
    assert port.report.times.t_agg == pytest.approx(ref.report.times.t_agg, rel=1e-12)
    # e_comp less the fit term (the loop engine prices its measured fit time)
    p_train = tcore.CostModel().device.p_train
    assert port.report.e_comp - port.report.times.t_loc * p_train == pytest.approx(
        ref.report.e_comp - ref.report.times.t_loc * p_train, rel=1e-9)
    assert port.report.e_comm == pytest.approx(ref.report.e_comm, rel=1e-12)


@pytest.mark.parametrize("name", list(WORLDS))
def test_loop_engine_matches_jax_loop_engine(name):
    jloop, _, tloop, _ = _run_world(name)
    _, over, _ = WORLDS[name]
    _assert_matches(jloop, tloop, robust=over["robust"], int8="compress" in over,
                    battery_rtol=1e-12)
    assert _masks(tloop, "corrupted_mask").sum() > 0      # the adversary fired


@pytest.mark.parametrize("name", list(WORLDS))
def test_fleet_matches_jax_fleet(name):
    _, jfleet, _, tfleet = _run_world(name)
    _, over, _ = WORLDS[name]
    _assert_matches(jfleet, tfleet, robust=over["robust"], int8="compress" in over,
                    battery_rtol=BATTERY_RTOL)


@pytest.mark.parametrize("name", list(WORLDS))
def test_port_fleet_matches_port_loop_engine(name):
    _, _, tloop, tfleet = _run_world(name)
    _, over, _ = WORLDS[name]
    n = tloop.n_contributors
    assert (tfleet.rounds, tfleet.stop_reason) == (tloop.rounds, tloop.stop_reason)
    for key in ("corrupted_mask", "clipped_mask"):
        assert np.array_equal(_masks(tfleet, key, n), _masks(tloop, key)), key
    np.testing.assert_allclose(tfleet.history_raw["battery"], tloop.history_raw["battery"],
                               rtol=BATTERY_RTOL)
    np.testing.assert_allclose(flatten_to_vector(tfleet.params)[0].numpy(),
                               flatten_to_vector(tloop.params)[0].numpy(),
                               **(INT8_TOL if "compress" in over else PARAM_TOL))
    assert tfleet.report.times.t_agg == pytest.approx(tloop.report.times.t_agg, rel=1e-12)


def test_clip_actually_clips():
    _, _, tloop, tfleet = _run_world("clip-actually-clips")
    assert _masks(tloop, "clipped_mask").sum() > 0
    assert _masks(tfleet, "clipped_mask").sum() > 0


def test_screening_never_drains_the_battery():
    """A defended and an undefended run of one world keep equal battery
    traces; only the report's t_agg / e_comp carry the screening."""
    akw, _, part = WORLDS["noise-clip"]
    ac = tadv.AdversaryConfig(**akw)
    defended, dfleet = _run_port(part, _cfg(tcore, ac, robust="clip"))
    plain, pfleet = _run_port(part, _cfg(tcore, ac))
    for d, p in ((defended, plain), (dfleet, pfleet)):
        assert d.history_raw["battery"] == p.history_raw["battery"]
        assert d.report.times.t_agg > p.report.times.t_agg
        assert "clipped_mask" not in p.history_raw
        assert np.array_equal(_masks(d, "corrupted_mask"), _masks(p, "corrupted_mask"))


@pytest.mark.parametrize("compress", [None, "int8"])
def test_p_zero_is_bit_identical_to_no_adversary(compress):
    """The adversary plumbing adds observability, never arithmetic."""
    none, none_f = _run_port(True, _cfg(tcore, None, compress=compress))
    zero, zero_f = _run_port(True, _cfg(tcore, tadv.AdversaryConfig(p_byzantine=0.0),
                                        compress=compress))
    for a, b in ((none, zero), (none_f, zero_f)):
        assert torch.equal(flatten_to_vector(a.params)[0], flatten_to_vector(b.params)[0])
        assert a.history_raw["battery"] == b.history_raw["battery"]
        assert "corrupted_mask" not in a.history_raw
        assert not _masks(b, "corrupted_mask").any()


def test_fleet_lanes_draw_their_own_weather():
    """Lane i is requester ``requester_id + i``: a fleet of two lanes
    equals two one-lane sessions whose configs carry those ids."""
    akw, over, part = WORLDS["signflip-trim"]
    ttask, own_train, own_test, tfleet, states_fn = _port_world(part)
    ac = tadv.AdversaryConfig(**akw)
    cfg = _cfg(tcore, ac, **over)
    specs = [tcore.RequesterSpec(own_train, own_test, tfleet, states_fn()) for _ in range(2)]
    two = tcore.run_fleet(ttask, specs, cfg, device=CPU)
    for i in range(2):
        lane_cfg = _cfg(tcore, tadv.AdversaryConfig(**akw, requester_id=ac.requester_id + i),
                        **over)
        one = tcore.EnFedSession(ttask, own_train, own_test, tfleet, states_fn(), lane_cfg,
                                 device=CPU).run()
        assert np.array_equal(_masks(two.sessions[i], "corrupted_mask", one.n_contributors),
                              _masks(one, "corrupted_mask"))
    assert not np.array_equal(two.history["corrupted"][:, 0], two.history["corrupted"][:, 1])
    assert two.history["clipped"].shape == two.history["corrupted"].shape


def test_loop_engine_never_modifies_the_resident_image():
    """Corruption touches only the delivered copy: with refresh off, the
    contributors' params after a fully corrupted run are the staged ones."""
    akw = dict(p_byzantine=1.0, attack="noise", scale=3.0, seed=7)
    ttask, own_train, own_test, tfleet, states_fn = _port_world(True)
    for compress in (None, "int8"):
        st = states_fn()
        before = {d: flatten_to_vector(v["params"])[0].clone() for d, v in st.items()}
        cfg = _cfg(tcore, tadv.AdversaryConfig(**akw), robust="median", compress=compress,
                   contributor_refresh_epochs=0, max_rounds=2)
        res = tcore.EnFedSession(ttask, own_train, own_test, tfleet, st, cfg, device=CPU).run()
        assert _masks(res, "corrupted_mask").all()
        for d, v in st.items():
            assert torch.equal(flatten_to_vector(v["params"])[0], before[d])

