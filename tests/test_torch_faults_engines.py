"""Both engines of the port in the unreliable-link world against the JAX
package on the CPU, on the reference's small problem
(``tests/test_fleet_engine.py::_build``): the worlds of
``tests/test_faults.py`` (static, the int8 wire, mobility with faults,
every link failed), staleness decay, the corner where every delivered
update weighs 0, the baseline fleets' fault pricing and a 2-requester run
through the facades.  The two fault worlds of ``tests/test_adversary.py``
run in ``tests/test_torch_faults_adversary.py`` on this file's helpers.

Each world runs once per module through the JAX loop engine, the JAX fleet
and the port's two engines (results cached by world): the port's loop
against the reference's loop, the port's fleet against the reference's
fleet, and the port's two engines against each other.  Deliver, member,
corrupted and clipped masks, the drop, retry and stale counts, rounds and
stops must match exactly; params within ``rtol=1e-4, atol=2e-5`` (fp32)
or ``atol=1e-2`` (int8), battery within ``rtol=1e-6``, and the priced
report (the retry windows included) to the float.
"""

import copy
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.api as japi  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.telemetry as jtel  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.api import ExecutionSpec, Experiment, MethodSpec, WorldSpec  # noqa: E402
from repro_torch.core.battery import BatteryState  # noqa: E402
from repro_torch.telemetry import compare_event_streams, validate_events  # noqa: E402

from _torch_ref import threefry  # noqa: E402
from test_fleet_engine import BATCH  # noqa: E402
from test_torch_mobility_engines import _port_world, _problem, _vec  # noqa: E402

CPU = torch.device("cpu")
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
INT8_TOL = dict(rtol=0, atol=1e-2)
BATTERY_RTOL = 1e-6
# the world of tests/test_faults.py: all three failure modes within 4 rounds
FC = dict(p_drop=0.6, p_stale=0.4, max_retries=1, release_after=2, seed=3)
MOB = dict(arena_m=120.0, radio_range_m=60.0, leg_rounds=2, seed=5)

WORLDS = {
    # name: config overrides (the faults default to FC)
    "static": {},
    "int8": dict(compress="int8"),
    "mobility": dict(mobility=MOB),
    "all-links-failed": dict(faults=dict(p_drop=1.0, max_retries=0, seed=0), max_rounds=3,
                             contributor_refresh_epochs=0),
    "decay": dict(staleness_gamma=0.5),
    # every delivered update is stale and weighs gamma**1 = 0 (satellite:
    # the eq. 14 clamp on an all-zero weight row)
    "zero-weights": dict(faults=dict(p_drop=0.3, p_stale=1.0, max_retries=0, seed=3),
                         staleness_gamma=0.0, max_rounds=3),
}
# worlds whose reference loop engine is compared (see the zero-weight test)
LOOP_WORLDS = [w for w in WORLDS if w != "zero-weights"]

_RUNS = {}


def _cfg(mod, **over):
    over = dict(over)
    base = dict(desired_accuracy=0.99, max_rounds=4, epochs=1, batch_size=BATCH,
                encrypt=False, contributor_refresh_epochs=1)
    over["faults"] = mod.FaultConfig(**over.get("faults", FC))
    if "mobility" in over:
        over["mobility"] = mod.MobilityConfig(**over["mobility"])
    if "adversary" in over:
        over["adversary"] = mod.AdversaryConfig(**over["adversary"])
    base.update(over)
    return mod.EnFedConfig(**base)


def _run_port(cfg):
    ttask, own_train, own_test, tfleet, states_fn = _port_world(True)
    loop = tcore.EnFedSession(ttask, own_train, own_test, tfleet, states_fn(), cfg,
                              battery=BatteryState(), device=CPU).run()
    spec = tcore.RequesterSpec(own_train, own_test, tfleet, states_fn(), BatteryState())
    fleet = tcore.run_fleet(ttask, [spec], cfg, device=CPU).sessions[0]
    return loop, fleet


def _run_world(name, worlds=WORLDS):
    """The world's runs: (reference loop, reference fleet, port loop, port
    fleet), each once per module."""
    if name not in _RUNS:
        task, own_train, own_test, fleet, states = _problem()
        with threefry(True):
            jcfg = _cfg(jcore, **worlds[name])
            jloop = jcore.EnFedSession(task, own_train, own_test, fleet, copy.deepcopy(states),
                                       jcfg, battery=jcore.BatteryState()).run()
            spec = jcore.RequesterSpec(own_train, own_test, fleet, copy.deepcopy(states),
                                       jcore.BatteryState())
            jfleet = jcore.run_fleet(task, [spec], jcfg).sessions[0]
        _RUNS[name] = (jloop, jfleet) + _run_port(_cfg(tcore, **worlds[name]))
    return _RUNS[name]


def _masks(res, key, width=None):
    """A (rounds, lanes) mask trace, zero-padded to ``width`` lanes (the
    fleet pads a static world's lanes to ``n_max``)."""
    m = np.stack(res.history_raw[key])
    return m if width is None else np.pad(m, ((0, 0), (0, width - m.shape[1])))


def _assert_matches(ref, port, *, over, battery_rtol):
    """Exact world and protocol state; params, battery and report to
    tolerance."""
    assert (port.rounds, port.stop_reason, port.n_contributors, port.model_bytes) == \
        (ref.rounds, ref.stop_reason, ref.n_contributors, ref.model_bytes)
    assert port.history_raw["round_executed"] == ref.history_raw["round_executed"]
    for key in ("drops", "retries", "stale"):
        assert port.history_raw[key] == ref.history_raw[key], key
    keys = ["deliver_mask"] + (["member_mask"] if "mobility" in over else []) + (
        ["corrupted_mask"] if "adversary" in over else []) + (
        ["clipped_mask"] if "robust" in over else [])
    for key in keys:
        width = max(len(port.history_raw[key][0]), len(ref.history_raw[key][0]))
        assert np.array_equal(_masks(port, key, width), _masks(ref, key, width)), key
    np.testing.assert_allclose(port.history_raw["accuracy"], ref.history_raw["accuracy"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.history_raw["battery"], ref.history_raw["battery"],
                               rtol=battery_rtol)
    np.testing.assert_allclose(_vec(port), _vec(ref),
                               **(INT8_TOL if "compress" in over else PARAM_TOL))
    # the retry windows are priced post hoc into t_com and e_comm; the loop
    # engines' t_loc is their own measured fit wall
    p_train = tcore.CostModel().device.p_train
    assert port.report.times.t_com == pytest.approx(ref.report.times.t_com, rel=1e-9)
    assert port.report.times.t_agg == pytest.approx(ref.report.times.t_agg, rel=1e-9)
    assert port.report.e_comm == pytest.approx(ref.report.e_comm, rel=1e-9)
    assert port.report.e_comp - port.report.times.t_loc * p_train == pytest.approx(
        ref.report.e_comp - ref.report.times.t_loc * p_train, rel=1e-9)


@pytest.mark.parametrize("name", LOOP_WORLDS)
def test_loop_engine_matches_jax_loop_engine(name):
    jloop, _, tloop, _ = _run_world(name)
    _assert_matches(jloop, tloop, over=WORLDS[name], battery_rtol=1e-12)


@pytest.mark.parametrize("name", list(WORLDS))
def test_fleet_matches_jax_fleet(name):
    _, jfleet, _, tfleet = _run_world(name)
    _assert_matches(jfleet, tfleet, over=WORLDS[name], battery_rtol=BATTERY_RTOL)


@pytest.mark.parametrize("name", list(WORLDS))
def test_port_fleet_matches_port_loop_engine(name):
    _, _, tloop, tfleet = _run_world(name)
    _assert_matches(tloop, tfleet, over=WORLDS[name], battery_rtol=BATTERY_RTOL)


def test_worlds_exercise_every_failure_mode():
    """The gates above see drops, retries, stale deliveries, blocked links,
    deliveries only from members under churn and dead rounds, not a perfect
    link."""
    _, _, static, _ = _run_world("static")
    tot = {k: sum(static.history_raw[k]) for k in ("drops", "retries", "stale")}
    assert min(tot.values()) > 0, tot
    # a blocked link sits out: it neither delivers nor counts as a drop
    dm = _masks(static, "deliver_mask")
    assert any(d + dm[r].sum() < dm.shape[1]
               for r, d in enumerate(static.history_raw["drops"]))
    _, _, mob, _ = _run_world("mobility")
    assert not (_masks(mob, "deliver_mask") > _masks(mob, "member_mask")).any()
    _, _, dead, _ = _run_world("all-links-failed")
    assert not _masks(dead, "deliver_mask").any()
    assert all(a > 0 for a in dead.history_raw["accuracy"])     # it trains alone


def test_the_all_zero_weight_corner_is_pinned():
    """``staleness_gamma=0`` with only stale deliveries: every delivered
    update weighs 0.  The reference's loop engine divides by the plain sum
    of the weights (``tree_weighted_mean``) and gives non-finite params and
    accuracy 0; its fleet clamps the sum at 1e-9 and, with a delivered
    count above 0, aggregates to zeros, which the requester then fits.  The
    port follows the reference's fleet in both engines (eq. 14's clamp),
    so the port's loop engine differs from the reference's loop here, and
    only here (``ROADMAP.md``, the state of the reference)."""
    jloop, jfleet, tloop, tfleet = _run_world("zero-weights")
    assert sum(jfleet.history_raw["stale"]) == _masks(jfleet, "deliver_mask").sum() > 0
    assert not np.isfinite(_vec(jloop)).all()
    assert jloop.history_raw["accuracy"] == [0.0] * jloop.rounds
    assert np.isfinite(_vec(jfleet)).all() and np.isfinite(_vec(tloop)).all()
    np.testing.assert_allclose(_vec(tloop), _vec(jfleet), **PARAM_TOL)
    np.testing.assert_allclose(tloop.history_raw["accuracy"], jfleet.history_raw["accuracy"],
                               atol=1e-6, rtol=0)
    for key in ("drops", "retries", "stale"):
        assert tloop.history_raw[key] == jloop.history_raw[key]


def test_retry_overhead_against_the_clean_world():
    """Drops and retries burn extra receive windows: the faulty world costs
    more transport energy and time than the clean one, by exactly the
    priced retry windows, in both engines."""
    _, _, faulty, faulty_fl = _run_world("static")
    clean_cfg = dataclasses.replace(_cfg(tcore), faults=None)
    clean, clean_fl = _run_port(clean_cfg)
    windows = sum(faulty.history_raw["drops"]) + sum(faulty.history_raw["retries"])
    e_rx, _, t_xfer = tcore.CostModel().retry_energy(model_bytes=faulty.model_bytes,
                                                     encrypt=False)
    for f, c in ((faulty, clean), (faulty_fl, clean_fl)):
        assert f.report.e_comm > c.report.e_comm and f.report.times.t_com > c.report.times.t_com
        assert f.report.times.t_com - c.report.times.t_com == pytest.approx(windows * t_xfer)
        assert np.isfinite(f.report.e_tot)
    assert faulty.report.e_comm - clean.report.e_comm == pytest.approx(windows * e_rx)


@pytest.mark.parametrize("method,topology", [("cfl", "mesh"), ("dfl", "mesh"),
                                             ("dfl", "ring")])
def test_baseline_fleets_price_faults_as_the_reference(method, topology):
    """cfl and dfl fleets price each extra transmission of their links (the
    WAN uplink, the gossip fan) post hoc: ``fault_extra_tx`` and the report
    equal the reference fleet's to the float."""
    task, own_train, own_test, fleet, states = _problem()
    with threefry(True):
        jres = jcore.run_fleet(task, [jcore.RequesterSpec(own_train, own_test, fleet, states)],
                               _cfg(jcore, max_rounds=3), method=method,
                               dfl_topology=topology).sessions[0]
    ttask, _, _, tfleet, states_fn = _port_world(True)
    tres = tcore.run_fleet(ttask, [tcore.RequesterSpec(own_train, own_test, tfleet,
                                                       states_fn())],
                           _cfg(tcore, max_rounds=3), method=method, dfl_topology=topology,
                           device=CPU).sessions[0]
    assert tres.history_raw["fault_extra_tx"] == jres.history_raw["fault_extra_tx"] > 0
    assert (tres.rounds, tres.stop_reason) == (jres.rounds, jres.stop_reason)
    assert tres.report.times.t_com == jres.report.times.t_com
    assert tres.report.e_comm == jres.report.e_comm


def test_two_requester_event_streams_match_across_engines_and_packages():
    """Through the facades, requester i rolls its link dice as
    ``requester_id + i`` in the port's loop runner as in its fleet and in
    the reference's loop runner: all three event streams are equal."""
    task, own_train, own_test, fleet, states = _problem()
    knobs = dict(desired_accuracy=0.99, max_rounds=3, epochs=1, batch_size=BATCH,
                 encrypt=False, contributor_refresh_epochs=1)
    ttask, _, _, tfleet, states_fn = _port_world(True)
    tworld = WorldSpec(task=ttask, requesters=[
        tcore.RequesterSpec(own_train, own_test, tfleet, states_fn()) for _ in range(2)],
        device="cpu")
    tmethod = MethodSpec(faults=tcore.FaultConfig(**FC), **knobs)
    loop, fl = (Experiment(tworld, tmethod, ExecutionSpec(engine=e)).run()
                for e in ("loop", "fleet"))
    assert compare_event_streams(validate_events(loop.trace), validate_events(fl.trace)) == []
    delivered = [np.stack(s.history_raw["deliver_mask"]) for s in loop.sessions]
    assert not np.array_equal(*delivered), "the two requesters roll their own link dice"
    with threefry(True):
        jworld = japi.WorldSpec(task=task, requesters=[
            jcore.RequesterSpec(own_train, own_test, fleet, copy.deepcopy(states))
            for _ in range(2)])
        ref = japi.Experiment(jworld, japi.MethodSpec(faults=jcore.FaultConfig(**FC), **knobs),
                              japi.ExecutionSpec(engine="loop")).run()
    port = jtel.validate_events([jtel.RoundEvent(**ev.__dict__) for ev in loop.trace])
    assert jtel.compare_event_streams(jtel.validate_events(ref.trace), port) == []
