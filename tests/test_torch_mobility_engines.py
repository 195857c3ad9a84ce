"""Both engines of the port in the opportunistic world against the JAX
package on the CPU, on the reference's small problem
(``tests/test_fleet_engine.py::_build``): the four churn worlds of
``tests/test_fleet_engine.py`` (waypoint churn, empty rounds, churn with
encryption, battery-floor releases), churn on the int8 wire, churn with
Byzantine links under ``robust="clip"``; and, in the port alone, a battery
stop and a strategy over the dynamic members.

Each world runs once per module through the JAX loop engine, the JAX fleet
and the port's two engines (the results are cached by world): the port's
loop against the reference's loop, the port's fleet against the
reference's fleet, and the port's loop against its own fleet.  Member
masks, member counts, corrupted and clipped masks, rounds and stops must
match exactly; params, battery and the priced report within the
tolerances of ``tests/test_torch_fleet.py``.
"""

import copy
import dataclasses
import os

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
from repro_torch.core.mobility import membership_events  # noqa: E402
from repro_torch.models import MLPClassifier, MLPClassifierConfig  # noqa: E402
from repro_torch.telemetry import compare_event_streams, validate_events  # noqa: E402
from repro_torch.utils.tree import flatten_to_vector, from_jax_params  # noqa: E402

from _torch_ref import RefInitTask, threefry  # noqa: E402
from test_fleet_engine import BATCH, _build  # noqa: E402

CPU = torch.device("cpu")
# rounds of Adam fits and refreshes: fp32 rounding in another order
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
# int8: the per-tile scale bound of tests/test_compress.py
INT8_TOL = dict(rtol=0, atol=1e-2)
# the fleet discharges the requester's battery in fp32, the loop engine in
# float64 (from the same fp32 table entries)
BATTERY_RTOL = 1e-6
ADVERSARY = dict(p_byzantine=0.5, attack="scale", scale=20.0, seed=7)

WORLDS = {
    # name: (mobility kwargs, config overrides, battery kwargs, threefry mode)
    "waypoint-churn": (dict(radio_range_m=110.0, leg_rounds=2, seed=3), {}, {}, True),
    "empty-rounds": (dict(radio_range_m=55.0, leg_rounds=2, seed=3), {}, {}, True),
    "churn-encrypted": (dict(radio_range_m=110.0, leg_rounds=2, seed=3),
                        dict(encrypt=True), {}, True),
    "floor-release": (dict(mode="static", radio_range_m=500.0, seed=3,
                           contributor_capacity_j=0.004, battery_floor=0.3), {}, {}, True),
    "churn-int8": (dict(radio_range_m=90.0, leg_rounds=1, seed=5),
                   dict(compress="int8", n_max=3), {}, True),
    "churn-clip": (dict(radio_range_m=90.0, leg_rounds=1, seed=5),
                   dict(adversary=ADVERSARY, robust="clip", n_max=3), {}, True),
}
# worlds held loop against fleet in the port alone (the reference's own
# tests hold its engines there); the ring world under the other threefry mode
PORT_WORLDS = {
    "battery-stop": (dict(radio_range_m=110.0, leg_rounds=2, seed=3), dict(n_max=3),
                     dict(capacity_j=0.2, level=0.3), True),
    "ring": (dict(radio_range_m=130.0, leg_rounds=2, seed=7),
             dict(n_max=3, max_rounds=4, strategy="dfl_ring"), {}, False),
}

_PROBLEM = {}
_RUNS = {}


def _problem():
    if not _PROBLEM:
        _PROBLEM["jax"] = _build()
    return _PROBLEM["jax"]


def _cfg(mod, mob_kw, **over):
    over = dict(over)
    base = dict(desired_accuracy=0.99, max_rounds=6, epochs=1, batch_size=BATCH,
                encrypt=False, n_max=2, contributor_refresh_epochs=1)
    if "adversary" in over:
        over["adversary"] = mod.AdversaryConfig(**over["adversary"])
    if "strategy" in over:
        over["strategy"] = mod.AggregationStrategy(kind=over["strategy"])
    base.update(over)
    return mod.EnFedConfig(mobility=mod.MobilityConfig(**mob_kw), **base)


def _port_world(partitionable):
    """The port's task (the reference's init, converted), fleet and a
    factory of fresh contributor states."""
    task, own_train, own_test, fleet, states = _problem()
    ttask = RefInitTask(MLPClassifier(MLPClassifierConfig(8, (16,), 5), device=CPU), task,
                        partitionable)
    tfleet = tcore.make_fleet(len(fleet), seed=1, p_has_model=1.0)
    for d in tfleet:
        d.reservation_price = 0.4

    def states_fn():
        return {did: {"params": from_jax_params(jax.tree_util.tree_map(np.asarray, st["params"]),
                                                CPU),
                      "data": st["data"]} for did, st in states.items()}
    return ttask, own_train, own_test, tfleet, states_fn


def _run_port(partitionable, cfg, battery_kw=None, chunk=4):
    """The port's loop session and one-lane fleet on fresh states; also the
    states each left behind."""
    ttask, own_train, own_test, tfleet, states_fn = _port_world(partitionable)
    battery_kw = battery_kw or {}
    lstates, fstates = states_fn(), states_fn()
    loop = tcore.EnFedSession(ttask, own_train, own_test, tfleet, lstates, cfg,
                              battery=BatteryState(**battery_kw), device=CPU).run()
    spec = tcore.RequesterSpec(own_train, own_test, tfleet, fstates, BatteryState(**battery_kw))
    fleet = tcore.run_fleet(ttask, [spec], cfg, round_chunk=chunk, device=CPU)
    return loop, fleet, lstates, fstates


def _run_world(name):
    if name in _RUNS:
        return _RUNS[name]
    if name in PORT_WORLDS:
        mob_kw, over, battery_kw, part = PORT_WORLDS[name]
        tloop, tfleet, _, _ = _run_port(part, _cfg(tcore, mob_kw, **over), battery_kw)
        _RUNS[name] = (None, None, tloop, tfleet.sessions[0])
        return _RUNS[name]
    mob_kw, over, battery_kw, part = WORLDS[name]
    task, own_train, own_test, fleet, states = _problem()
    with threefry(part):
        jcfg = _cfg(jcore, mob_kw, **over)
        jloop = jcore.EnFedSession(task, own_train, own_test, fleet, copy.deepcopy(states), jcfg,
                                   battery=jcore.BatteryState(**battery_kw)).run()
        spec = jcore.RequesterSpec(own_train, own_test, fleet, copy.deepcopy(states),
                                   jcore.BatteryState(**battery_kw))
        jfleet = jcore.run_fleet(task, [spec], jcfg).sessions[0]
    tloop, tfleet, _, _ = _run_port(part, _cfg(tcore, mob_kw, **over), battery_kw)
    _RUNS[name] = (jloop, jfleet, tloop, tfleet.sessions[0])
    return _RUNS[name]


def _masks(res, key):
    return np.stack(res.history_raw[key])


def _vec(res):
    if isinstance(res, tcore.SessionResult):
        return flatten_to_vector(res.params)[0].numpy()
    return np.asarray(jax.flatten_util.ravel_pytree(res.params)[0])


def _assert_matches(ref, port, *, over, battery_rtol, report=True):
    """Exact world and protocol state; params and battery to tolerance."""
    assert (port.rounds, port.stop_reason, port.n_contributors, port.model_bytes) == \
        (ref.rounds, ref.stop_reason, ref.n_contributors, ref.model_bytes)
    assert np.array_equal(_masks(port, "member_mask"), _masks(ref, "member_mask"))
    assert port.history_raw["members"] == ref.history_raw["members"]
    assert port.history_raw["round_executed"] == ref.history_raw["round_executed"]
    keys = (("corrupted_mask",) if "adversary" in over else ()) + (
        ("clipped_mask",) if "robust" in over else ())
    for key in keys:
        assert np.array_equal(_masks(port, key), _masks(ref, key)), key
    assert ("corrupted_mask" in port.history_raw) == ("adversary" in over)
    np.testing.assert_allclose(port.history_raw["accuracy"], ref.history_raw["accuracy"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.history_raw["battery"], ref.history_raw["battery"],
                               rtol=battery_rtol)
    np.testing.assert_allclose(_vec(port), _vec(ref),
                               **(INT8_TOL if "compress" in over else PARAM_TOL))
    if report:
        # the report prices the mean membership (and the screening pass);
        # the loop engines' t_loc is their own measured fit wall
        p_train = tcore.CostModel().device.p_train
        assert port.report.times.t_com == pytest.approx(ref.report.times.t_com, rel=1e-9)
        assert port.report.times.t_agg == pytest.approx(ref.report.times.t_agg, rel=1e-9)
        assert port.report.e_comm == pytest.approx(ref.report.e_comm, rel=1e-9)
        assert port.report.e_comp - port.report.times.t_loc * p_train == pytest.approx(
            ref.report.e_comp - ref.report.times.t_loc * p_train, rel=1e-9)


@pytest.mark.parametrize("name", list(WORLDS))
def test_loop_engine_matches_jax_loop_engine(name):
    jloop, _, tloop, _ = _run_world(name)
    _assert_matches(jloop, tloop, over=WORLDS[name][1], battery_rtol=1e-12)
    # the loop engine's per-round contract lists, best utility first
    for jc, tc in zip(jloop.history_raw["contracts"], tloop.history_raw["contracts"]):
        assert [(c.device_id, c.utility) for c in tc] == [(c.device_id, c.utility) for c in jc]


@pytest.mark.parametrize("name", list(WORLDS))
def test_fleet_matches_jax_fleet(name):
    _, jfleet, _, tfleet = _run_world(name)
    _assert_matches(jfleet, tfleet, over=WORLDS[name][1], battery_rtol=BATTERY_RTOL)
    # the fleet prices the mean membership in fp32, as the reference's does
    assert tfleet.report.times.t_com == jfleet.report.times.t_com


@pytest.mark.parametrize("name", list(WORLDS) + list(PORT_WORLDS))
def test_port_fleet_matches_port_loop_engine(name):
    _, _, tloop, tfleet = _run_world(name)
    over = {**WORLDS, **PORT_WORLDS}[name][1]
    _assert_matches(tloop, tfleet, over=over, battery_rtol=BATTERY_RTOL, report=False)


def test_worlds_exercise_renegotiation():
    """The gates above must see churn, member-less rounds, floor releases,
    a battery stop and the adversary firing, not a static mask."""
    _, _, churn, _ = _run_world("waypoint-churn")
    masks = _masks(churn, "member_mask")
    assert (masks != masks[0]).any() and sum(membership_events(masks)) > 0
    _, _, empty, _ = _run_world("empty-rounds")
    assert 0.0 in empty.history_raw["members"] and max(empty.history_raw["members"]) > 0
    _, _, floor, _ = _run_world("floor-release")
    fm = _masks(floor, "member_mask")
    assert fm[0].tolist() != fm[-1].tolist()          # static positions: the floor churns
    _, _, stop, _ = _run_world("battery-stop")
    assert stop.stop_reason == "battery_low"
    _, _, clip, _ = _run_world("churn-clip")
    assert _masks(clip, "corrupted_mask").sum() > 0 and _masks(clip, "clipped_mask").sum() > 0
    # a corrupted link counts only while it is a member
    assert not (_masks(clip, "corrupted_mask") > _masks(clip, "member_mask")).any()
    _, _, ring, _ = _run_world("ring")
    assert max(ring.history_raw["members"]) == 3


def test_fleet_is_invariant_to_round_chunk():
    mob_kw, over, _, part = WORLDS["empty-rounds"]
    cfg = _cfg(tcore, mob_kw, **over)
    runs = [_run_port(part, cfg, chunk=c)[1] for c in (1, 3, 8)]
    for res in runs[1:]:
        assert np.array_equal(res.history["member"], runs[0].history["member"])
        assert np.array_equal(res.history["round_executed"][:res.rounds.max()],
                              runs[0].history["round_executed"][:res.rounds.max()])
        assert res.rounds.tolist() == runs[0].rounds.tolist()
        assert torch.equal(flatten_to_vector(res.sessions[0].params)[0],
                           flatten_to_vector(runs[0].sessions[0].params)[0])
        assert res.battery_level.tolist() == runs[0].battery_level.tolist()


def test_multi_lane_fleet_matches_per_lane_loops():
    """Lane i walks as requester ``requester_id + i``: a fleet of three
    lanes equals three loop sessions configured with those ids."""
    mob_kw, over, _, part = WORLDS["waypoint-churn"]
    ttask, own_train, own_test, tfleet, states_fn = _port_world(part)
    cfg = dataclasses.replace(_cfg(tcore, mob_kw, **over), max_rounds=4)
    specs = [tcore.RequesterSpec(own_train, own_test, tfleet, states_fn()) for _ in range(3)]
    fleet = tcore.run_fleet(ttask, specs, cfg, device=CPU)
    assert fleet.history["member"].shape == (4, 3, 3)
    seen = set()
    for lane in range(3):
        lane_cfg = dataclasses.replace(cfg, mobility=dataclasses.replace(
            cfg.mobility, requester_id=cfg.mobility.requester_id + lane))
        loop = tcore.EnFedSession(ttask, own_train, own_test, tfleet, states_fn(), lane_cfg,
                                  device=CPU).run()
        _assert_matches(loop, fleet.sessions[lane], over=over, battery_rtol=BATTERY_RTOL,
                        report=False)
        seen.add(tuple(loop.history_raw["members"]))
    assert len(seen) > 1, "lanes should see distinct neighbourhoods"


def test_write_back_holds_the_refreshed_members():
    """Only devices that were members while the session went on train; both
    engines leave the same contributor params behind, and a candidate that
    was never a member keeps its staged params."""
    mob_kw, over, _, part = WORLDS["waypoint-churn"]
    cfg = dataclasses.replace(_cfg(tcore, mob_kw, **over), max_rounds=4)
    loop, fleet, lstates, fstates = _run_port(part, cfg)
    staged = _port_world(part)[4]()
    masks = _masks(loop, "member_mask")
    # the members of every round the session went on past (the last budget
    # round refreshes too)
    ever = (masks if loop.stop_reason == "max_rounds" else masks[:-1]).any(axis=0)
    ids = [d.device_id for d in _port_world(part)[3]]
    assert ever.any() and not ever.all()
    for j, did in enumerate(ids):
        lv, fv = (flatten_to_vector(s[did]["params"])[0] for s in (lstates, fstates))
        sv = flatten_to_vector(staged[did]["params"])[0]
        torch.testing.assert_close(fv, lv, **PARAM_TOL)
        assert bool(ever[j]) == (not torch.equal(lv, sv))
        if not ever[j]:
            assert torch.equal(fv, sv)


def test_session_fleet_engine_flag_with_mobility():
    """``EnFedSession.run(engine="fleet")`` carries the mobility world to a
    one-requester fleet: the same bits as ``run_fleet``."""
    mob_kw, over, _, part = WORLDS["waypoint-churn"]
    cfg = dataclasses.replace(_cfg(tcore, mob_kw, **over), max_rounds=3,
                              contributor_refresh_epochs=0)
    ttask, own_train, own_test, tfleet, states_fn = _port_world(part)
    res = tcore.EnFedSession(ttask, own_train, own_test, tfleet, states_fn(), cfg,
                             device=CPU).run(engine="fleet")
    ref = tcore.run_fleet(ttask, [tcore.RequesterSpec(own_train, own_test, tfleet, states_fn())],
                          cfg, device=CPU).sessions[0]
    assert res.history_raw["member_mask"] is not None
    assert np.array_equal(_masks(res, "member_mask"), _masks(ref, "member_mask"))
    assert torch.equal(flatten_to_vector(res.params)[0], flatten_to_vector(ref.params)[0])
    loop = tcore.EnFedSession(ttask, own_train, own_test, tfleet, states_fn(), cfg,
                              device=CPU).run()
    _assert_matches(loop, res, over=over, battery_rtol=BATTERY_RTOL, report=False)


def test_two_requester_event_streams_match_across_engines_and_packages():
    """Through the facades: requester i walks as ``requester_id + i`` in the
    port's loop runner as in its fleet and in the reference's loop runner,
    so all three event streams are equal."""
    task, own_train, own_test, fleet, states = _problem()
    mob_kw, over, _, part = WORLDS["waypoint-churn"]
    knobs = dict(desired_accuracy=0.99, max_rounds=4, epochs=1, batch_size=BATCH,
                 encrypt=False, n_max=2, contributor_refresh_epochs=1)
    ttask, _, _, tfleet, states_fn = _port_world(part)
    tworld = WorldSpec(task=ttask, requesters=[
        tcore.RequesterSpec(own_train, own_test, tfleet, states_fn()) for _ in range(2)],
        mobility=tcore.MobilityConfig(**mob_kw), device="cpu")
    loop, fl = (Experiment(tworld, MethodSpec(**knobs), ExecutionSpec(engine=e)).run()
                for e in ("loop", "fleet"))
    assert compare_event_streams(validate_events(loop.trace), validate_events(fl.trace)) == []
    members = [tuple(s.history_raw["members"]) for s in loop.sessions]
    assert members[0] != members[1], "the two requesters walk their own trajectories"
    with threefry(part):
        jworld = japi.WorldSpec(task=task, requesters=[
            jcore.RequesterSpec(own_train, own_test, fleet, copy.deepcopy(states))
            for _ in range(2)], mobility=jcore.MobilityConfig(**mob_kw))
        ref = japi.Experiment(jworld, japi.MethodSpec(**knobs),
                              japi.ExecutionSpec(engine="loop")).run()
    port = jtel.validate_events([jtel.RoundEvent(**ev.__dict__) for ev in loop.trace])
    assert jtel.compare_event_streams(jtel.validate_events(ref.trace), port) == []


@pytest.mark.parametrize("engine", ["loop", "fleet"])
@pytest.mark.parametrize("knob,kwargs,sub", [(dict(cadence=tcore.CadenceConfig(
    n_speed_classes=2, duty_cycle=3, duty_on=2, seed=3)), {}, "E.3")])
def test_unported_knobs_under_mobility_raise_naming_their_slice(engine, knob, kwargs, sub):
    """The knob the session refused under churn before slice ``sub`` runs
    now on both engines: membership renegotiated on the event steps the
    requester ticks on (held to the reference in
    ``tests/test_torch_cadence_worlds.py``)."""
    mob_kw, over, _, part = WORLDS["waypoint-churn"]
    cfg = dataclasses.replace(_cfg(tcore, mob_kw, **over), max_rounds=3, **knob)
    ttask, own_train, own_test, tfleet, states_fn = _port_world(part)
    session = tcore.EnFedSession(ttask, own_train, own_test, tfleet, states_fn(), cfg,
                                 device=CPU)
    res = session.run(engine=engine, **kwargs)
    assert res.rounds == 3, f"slice {sub}"
    clock = res.history_raw["round_clock"]
    assert len(_masks(res, "member_mask")) == len(clock) == 3 and clock[-1] > 2


@pytest.mark.parametrize("engine", ["loop", "fleet"])
@pytest.mark.parametrize("knob,kwargs", [
    (dict(faults=tcore.FaultConfig(p_drop=0.5, p_stale=0.4, max_retries=1, seed=3)), {}),
    (dict(staleness_gamma=0.5), {}), ({}, dict(checkpoint_dir="ckpt")),
    ({}, dict(resume_from="ckpt"))])
def test_fault_slice_knobs_run_under_mobility(engine, knob, kwargs, tmp_path):
    """The knobs the fault slice ported run under churn on both engines; a
    resumed session gives the bits of the straight one (the churn world's
    own parity with the reference under faults: ``test_torch_faults_engines.py``)."""
    mob_kw, over, _, part = WORLDS["waypoint-churn"]
    cfg = dataclasses.replace(_cfg(tcore, mob_kw, **over), max_rounds=3, **knob)
    ttask, own_train, own_test, tfleet, states_fn = _port_world(part)

    def run(**kw):
        return tcore.EnFedSession(ttask, own_train, own_test, tfleet, states_fn(), cfg,
                                  device=CPU).run(engine=engine, round_chunk=1, **kw)

    ckpt = str(tmp_path / "ckpt")
    if "resume_from" in kwargs:
        straight = run(checkpoint_dir=ckpt)
        os.remove(os.path.join(ckpt, "step_00000003.npz"))
        res = run(resume_from=ckpt)
        assert torch.equal(flatten_to_vector(res.params)[0],
                           flatten_to_vector(straight.params)[0])
        assert np.array_equal(_masks(res, "member_mask"), _masks(straight, "member_mask"))
        return
    res = run(**{k: ckpt for k in kwargs})
    assert res.rounds == 3 and np.isfinite(res.history_raw["accuracy"]).all()
    if kwargs:
        assert sorted(os.listdir(ckpt)) == [f"step_{r:08d}.npz" for r in (1, 2, 3)]
    if "faults" in knob:
        assert not (_masks(res, "deliver_mask") > _masks(res, "member_mask")).any()
