"""Both engines of the port in the asynchronous-cadence world against the
JAX package on the CPU, on the reference's small problem
(``tests/test_fleet_engine.py::_build``): the static engine worlds of
``tests/test_cadence.py`` (a requester that idles, stragglers, duty cycle
and offline steps), the always-tick cadence bit-equal to ``cadence=None``,
the enfed-only refusal, and kill and resume on both engines.  Its worlds
with faults and mobility run in ``tests/test_torch_cadence_worlds.py``,
those with battery pacing and image-lag decay in
``tests/test_torch_cadence_coupled.py``, on this file's helpers.

Each world runs once per module through the JAX loop engine, the JAX fleet
and the port's two engines (results cached by world), each port engine
against each reference engine and against the other.  Tick sets, round
clocks, idle counts, rounds, stops and the member and deliver masks must
match exactly; params within ``rtol=1e-4, atol=1e-5``, battery within
``rtol=1e-5, atol=1e-6``, and the idle-priced ``t_com`` within 1e-9.

Every world pins its threefry mode.  The reference's ``seed=0`` puts the
requester on stride 2 only under ``jax_threefry_partitionable=False``
(its CI's jax 0.4.37 default), so the worlds that assert an idling
requester run under False, the mode in which the reference's own
assertions hold.
"""

import copy
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import cadence as jcadence  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import cadence as tcadence  # noqa: E402
from repro_torch.core.battery import BatteryState  # noqa: E402
from repro_torch.utils.tree import flatten_to_vector  # noqa: E402

from _torch_ref import threefry  # noqa: E402
from test_fleet_engine import BATCH  # noqa: E402
from test_torch_checkpoint_resume import _kill_after  # noqa: E402
from test_torch_mobility_engines import _port_world, _problem, _vec  # noqa: E402

CPU = torch.device("cpu")
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
BATTERY_TOL = dict(rtol=1e-5, atol=1e-6)
# the reference's two cadences: seed 0 puts the requester on stride 2
# (under partitionable=False), seed 5 the requester on stride 1 with
# stride-2 contributors
SLOW_REQ = dict(n_speed_classes=2, seed=0)
STRAGGLER = dict(n_speed_classes=2, seed=5)

WORLDS = {
    # name: (cadence, config overrides, battery kwargs, threefry mode)
    "requester-idles": (SLOW_REQ, dict(max_rounds=3, epochs=2), {}, False),
    "stragglers": (STRAGGLER, dict(max_rounds=3, epochs=2), {}, False),
    "duty-offline": (dict(n_speed_classes=2, duty_cycle=3, duty_on=2, p_offline=0.15, seed=1),
                     {}, {}, False),
    "faults": (STRAGGLER, dict(faults=dict(p_drop=0.3, p_stale=0.25, max_retries=1, seed=7)),
               {}, False),
    "mobility": (SLOW_REQ, dict(mobility=dict(seed=3)), {}, False),
    "pacing": (dict(pace_battery_threshold=0.87, pace_factor=2, seed=2),
               dict(max_rounds=4, battery_threshold=0.05), dict(capacity_j=4.0, level=0.9),
               False),
    # image-lag decay on stride-2 stragglers, under the other threefry mode
    "decay": (dict(n_speed_classes=2, seed=4), dict(staleness_gamma=0.5), {}, True),
    # the event budget ends the session between two of the requester's
    # ticks: 2 rounds of 3, then one trailing idle step to price
    "budget": (dict(SLOW_REQ, max_events=5), {}, {}, False),
}

# the worlds this file holds (the others: tests/test_torch_cadence_worlds.py
# and tests/test_torch_cadence_coupled.py)
STATIC_WORLDS = ["requester-idles", "stragglers", "duty-offline"]
PAIRS = ["loop-loop", "fleet-fleet", "loop-fleet", "fleet-loop", "port-loop-fleet"]

_RUNS = {}


def _cfg(mod, cad, **over):
    over = dict(over)
    base = dict(desired_accuracy=0.99, max_rounds=3, epochs=1, batch_size=BATCH,
                encrypt=False, contributor_refresh_epochs=1)
    if "faults" in over:
        over["faults"] = mod.FaultConfig(**over["faults"])
    if "mobility" in over:
        over["mobility"] = mod.MobilityConfig(**over["mobility"])
    base.update(over)
    return mod.EnFedConfig(cadence=mod.CadenceConfig(**cad), **base)


def _run_port(part, cfg, battery_kw=None, **run_kw):
    """The port's loop session and one-lane fleet on fresh states."""
    ttask, own_train, own_test, tfleet, states_fn = _port_world(part)
    bk = battery_kw or {}
    loop = tcore.EnFedSession(ttask, own_train, own_test, tfleet, states_fn(), cfg,
                              battery=BatteryState(**bk), device=CPU).run(**run_kw)
    spec = tcore.RequesterSpec(own_train, own_test, tfleet, states_fn(), BatteryState(**bk))
    fleet = tcore.run_fleet(ttask, [spec], cfg, device=CPU, **run_kw).sessions[0]
    return loop, fleet


def _run_world(name):
    """(reference loop, reference fleet, port loop, port fleet), once per
    module."""
    if name not in _RUNS:
        cad, over, bk, part = WORLDS[name]
        task, own_train, own_test, fleet, states = _problem()
        with threefry(part):
            jcfg = _cfg(jcore, cad, **over)
            jloop = jcore.EnFedSession(task, own_train, own_test, fleet, copy.deepcopy(states),
                                       jcfg, battery=jcore.BatteryState(**bk)).run()
            spec = jcore.RequesterSpec(own_train, own_test, fleet, copy.deepcopy(states),
                                       jcore.BatteryState(**bk))
            jfleet = jcore.run_fleet(task, [spec], jcfg).sessions[0]
        _RUNS[name] = (jloop, jfleet) + _run_port(part, _cfg(tcore, cad, **over), bk)
    return _RUNS[name]


def _assert_async_parity(a, b):
    """Exact on the asynchronous trajectory, to tolerance on the floats."""
    ha, hb = a.history_raw, b.history_raw
    assert (a.rounds, a.stop_reason) == (b.rounds, b.stop_reason)
    assert ha["round_clock"] == hb["round_clock"]
    assert ha["idle_steps"] == hb["idle_steps"]
    for key in ("drops", "retries", "stale"):
        if key in ha:
            assert ha[key] == hb[key], key
    for key in ("member_mask", "deliver_mask"):
        if key in ha:
            ma, mb = np.stack(ha[key]), np.stack(hb[key])
            width = max(ma.shape[1], mb.shape[1])
            pad = [np.pad(m, ((0, 0), (0, width - m.shape[1]))) for m in (ma, mb)]
            assert np.array_equal(*pad), key
    np.testing.assert_allclose(hb["battery"], ha["battery"], **BATTERY_TOL)
    np.testing.assert_allclose(hb["accuracy"], ha["accuracy"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_vec(b), _vec(a), **PARAM_TOL)
    # the idle steps are priced through the one helper in every engine
    assert abs(a.report.times.t_com - b.report.times.t_com) < 1e-9
    assert abs(a.report.e_comm - b.report.e_comm) < 1e-9


def check_pair(name, pair):
    jloop, jfleet, tloop, tfleet = _run_world(name)
    ref, port = {"loop-loop": (jloop, tloop), "fleet-fleet": (jfleet, tfleet),
                 "loop-fleet": (jloop, tfleet), "fleet-loop": (jfleet, tloop),
                 "port-loop-fleet": (tloop, tfleet)}[pair]
    _assert_async_parity(ref, port)


def check_tick_sets(name):
    """The contributors' tick sets on every executed step, and the
    requester's, are the reference's bit for bit."""
    cad, _, _, part = WORLDS[name]
    _, _, tloop, _ = _run_world(name)
    ids = np.arange(3, dtype=np.int32)
    steps = tloop.history_raw["round_clock"]
    with threefry(part):
        jcc = jcore.CadenceConfig(**cad)
        want = [np.asarray(jcadence.tick_mask(jcc, t, ids)) for t in steps]
        want_req = [bool(jcadence.tick_mask(jcc, t, jcc.requester_id)) for t in steps]
    tcc = tcore.CadenceConfig(**cad)
    got = [tcadence.tick_mask(tcc, t, ids, partitionable=part).numpy() for t in steps]
    assert np.array_equal(np.stack(want), np.stack(got))
    # without pacing the requester ticks on every executed step
    assert all(want_req) or cad.get("pace_factor", 1) > 1


@pytest.mark.parametrize("name", STATIC_WORLDS)
@pytest.mark.parametrize("pair", PAIRS)
def test_port_engines_match_the_reference_engines(name, pair):
    check_pair(name, pair)


@pytest.mark.parametrize("name", STATIC_WORLDS)
def test_port_tick_sets_are_the_reference_ticks(name):
    check_tick_sets(name)


def test_the_worlds_exercise_what_they_name():
    """The requester idles on stride 2, stragglers skip a refresh, the duty
    window leaves gaps (the reference's own assertions, on the port)."""
    _, _, idles, _ = _run_world("requester-idles")
    assert idles.history_raw["round_clock"] == [1, 3, 5]
    assert idles.history_raw["idle_steps"] == [1, 1, 1]
    assert idles.report.times.t_com > 0
    _, _, strag, _ = _run_world("stragglers")
    ids = np.arange(3, dtype=np.int64)
    cc = tcore.CadenceConfig(**STRAGGLER)
    straggled = sum(int((~tcadence.tick_mask(cc, t, ids, partitionable=False)).sum())
                    for t in strag.history_raw["round_clock"])
    assert straggled >= 1, "no straggler round"
    _, _, duty, _ = _run_world("duty-offline")
    assert max(duty.history_raw["idle_steps"]) >= 2


def test_always_tick_cadence_is_lockstep_bit_for_bit():
    """One speed class, no duty, offline or pacing, budget = round budget:
    the bits of ``cadence=None`` in both port engines, with ``t == r``."""
    base = dict(desired_accuracy=0.99, max_rounds=2, epochs=1, batch_size=BATCH,
                encrypt=False, contributor_refresh_epochs=1)
    off = tcore.EnFedConfig(**base)
    on = tcore.EnFedConfig(cadence=tcore.CadenceConfig(max_events=2), **base)
    for a, b in zip(_run_port(True, off), _run_port(True, on)):
        assert torch.equal(flatten_to_vector(a.params)[0], flatten_to_vector(b.params)[0])
        assert a.history_raw["battery"] == b.history_raw["battery"]
        assert a.history_raw["accuracy"] == b.history_raw["accuracy"]
        assert b.history_raw["round_clock"] == [0, 1]
        assert b.history_raw["idle_steps"] == [0, 0]
        assert a.report.times.t_com == b.report.times.t_com


@pytest.mark.parametrize("method", ["dfl", "cfl"])
def test_cadence_is_enfed_only(method):
    ttask, own_train, own_test, tfleet, states_fn = _port_world(True)
    cfg = tcore.EnFedConfig(max_rounds=1, cadence=tcore.CadenceConfig())
    with pytest.raises(ValueError, match="cadence"):
        tcore.run_fleet(ttask, [tcore.RequesterSpec(own_train, own_test, tfleet, states_fn())],
                        cfg, method=method, device=CPU)


@pytest.mark.parametrize("engine", ["loop", "fleet"])
def test_kill_and_resume_with_cadence(engine, tmp_path):
    """Killed after step 2 and resumed equals the straight run bit for bit,
    the event clock and the idle run restored (the fleet at event-step
    chunks of 2)."""
    cfg = _cfg(tcore, SLOW_REQ, max_rounds=4)
    ttask, own_train, own_test, tfleet, states_fn = _port_world(False)
    kw = dict(round_chunk=2) if engine == "fleet" else {}

    def run(**run_kw):
        session = tcore.EnFedSession(ttask, own_train, own_test, tfleet, states_fn(), cfg,
                                     battery=BatteryState(), device=CPU)
        return session.run(engine=engine, **kw, **run_kw)

    full = run()
    d = str(tmp_path / engine)
    saved = run(checkpoint_dir=d)
    _kill_after(d, 2)
    res = run(resume_from=d)
    for other in (saved, res):
        assert torch.equal(flatten_to_vector(full.params)[0], flatten_to_vector(other.params)[0])
        assert (other.rounds, other.stop_reason) == (full.rounds, full.stop_reason)
        for key in ("round_clock", "idle_steps", "battery", "accuracy", "loss"):
            assert other.history_raw[key] == full.history_raw[key], key
        assert other.report.times.t_com == full.report.times.t_com
    assert full.history_raw["idle_steps"] == [1, 1, 1, 1]
    assert os.listdir(d)


def test_composed_world_resumes_bit_for_bit(tmp_path):
    """Cadence with churn, faults and the int8 wire: the fleet of two lanes
    killed mid-run and resumed gives the straight run's bits in both
    lanes."""
    cfg = _cfg(tcore, dict(n_speed_classes=2, duty_cycle=3, duty_on=2, p_offline=0.15, seed=3),
               max_rounds=4, compress="int8", staleness_gamma=0.5,
               faults=dict(p_drop=0.3, p_stale=0.3, max_retries=1, release_after=2, seed=7),
               mobility=dict(arena_m=120.0, radio_range_m=60.0, leg_rounds=2, seed=5))
    ttask, own_train, own_test, tfleet, states_fn = _port_world(True)

    def run(**kw):
        specs = [tcore.RequesterSpec(own_train, own_test, tfleet, states_fn()) for _ in range(2)]
        return tcore.run_fleet(ttask, specs, cfg, device=CPU, round_chunk=2, **kw)

    full = run()
    d = str(tmp_path / "fleet")
    run(checkpoint_dir=d)
    _kill_after(d, 4)
    res = run(resume_from=d)
    assert np.array_equal(full.rounds, res.rounds)
    for key, v in full.history.items():
        assert np.array_equal(v, res.history[key]), key
    for a, b in zip(full.sessions, res.sessions):
        assert torch.equal(flatten_to_vector(a.params)[0], flatten_to_vector(b.params)[0])
        assert a.report.times.t_com == b.report.times.t_com
    assert sum(full.history["idle_steps"].ravel()) > 0


def test_a_cadence_checkpoint_resumes_across_the_packages(tmp_path):
    """The loop payload's layout is the reference's, event clock included:
    a reference session killed after round 2 of 3 resumes in the port, and
    a port session killed there resumes in the reference, each ending where
    the resuming package's straight run ends (clocks and idle steps exact,
    params within the engines' limit)."""
    cad, over, _, part = WORLDS["requester-idles"]
    jstraight, _, tstraight, _ = _run_world("requester-idles")
    task, own_train, own_test, fleet, states = _problem()
    ttask, _, _, tfleet, states_fn = _port_world(part)

    def ref(**kw):
        with threefry(part):
            return jcore.EnFedSession(task, own_train, own_test, fleet, copy.deepcopy(states),
                                      _cfg(jcore, cad, **over),
                                      battery=jcore.BatteryState()).run(**kw)

    def port(**kw):
        return tcore.EnFedSession(ttask, own_train, own_test, tfleet, states_fn(),
                                  _cfg(tcore, cad, **over), battery=BatteryState(),
                                  device=CPU).run(**kw)

    for write, resume, straight in ((ref, port, tstraight), (port, ref, jstraight)):
        d = str(tmp_path / write.__name__)
        write(checkpoint_dir=d)
        _kill_after(d, 2)
        resumed = resume(resume_from=d)
        assert resumed.history_raw["round_clock"] == straight.history_raw["round_clock"]
        assert resumed.history_raw["idle_steps"] == straight.history_raw["idle_steps"]
        assert (resumed.rounds, resumed.stop_reason) == (straight.rounds, straight.stop_reason)
        np.testing.assert_allclose(_vec(resumed), _vec(straight), **PARAM_TOL)
        assert abs(resumed.report.times.t_com - straight.report.times.t_com) < 1e-9
