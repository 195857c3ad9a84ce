"""The port's two engines in the asynchronous-cadence worlds where the
clock meets the session's state: battery pacing (the one state-coupled
rule of ``tests/test_cadence.py``), the decay of a lagging image
(``staleness_gamma < 1``, under the other threefry mode) and an event
budget that ends the session between two ticks (its trailing idle step
priced), against the JAX package's two engines on the CPU, on the helpers
and limits of ``tests/test_torch_cadence_engines.py``; and a 2-requester
run through both facades, whose event streams must be equal."""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.api as japi  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.telemetry as jtel  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.api import ExecutionSpec, Experiment, MethodSpec, WorldSpec  # noqa: E402
from repro_torch.core import cadence as tcadence  # noqa: E402
from repro_torch.telemetry import compare_event_streams, validate_events  # noqa: E402

from _torch_ref import threefry  # noqa: E402
from test_fleet_engine import BATCH  # noqa: E402
from test_torch_cadence_engines import (PAIRS, WORLDS, _cfg, _run_port, _run_world,  # noqa: E402
                                        check_pair, check_tick_sets)
from test_torch_mobility_engines import _port_world, _problem  # noqa: E402

COUPLED_WORLDS = ["pacing", "decay", "budget"]


@pytest.mark.parametrize("name", COUPLED_WORLDS)
@pytest.mark.parametrize("pair", PAIRS)
def test_port_engines_match_the_reference_engines(name, pair):
    check_pair(name, pair)


@pytest.mark.parametrize("name", COUPLED_WORLDS)
def test_port_tick_sets_are_the_reference_ticks(name):
    check_tick_sets(name)


def test_the_worlds_exercise_what_they_name():
    """Pacing slows the clock mid-run, decay meets a lagging image, and the
    budget leaves the requester one idle step after its last round, priced
    like any other: one step less of budget costs exactly one idle step's
    time."""
    _, _, paced, _ = _run_world("pacing")
    assert paced.history_raw["round_clock"][0] == 0
    assert max(paced.history_raw["idle_steps"][1:]) >= 1
    _, _, decay, _ = _run_world("decay")
    cc = tcore.CadenceConfig(**WORLDS["decay"][0])
    ids = np.arange(3, dtype=np.int64)
    lags = [tcadence.image_lag(cc, t, ids).numpy() for t in decay.history_raw["round_clock"]]
    assert max(int(v.max()) for v in lags) >= 1
    cad, over, _, part = WORLDS["budget"]
    _, _, cut, cut_fleet = _run_world("budget")
    assert (cut.rounds, cut.history_raw["round_clock"]) == (2, [1, 3])
    assert cut.history_raw["idle_steps"] == [1, 1]
    tight, tight_fleet = _run_port(part, _cfg(tcore, dict(cad, max_events=4), **over))
    for a, b in ((cut, tight), (cut_fleet, tight_fleet)):
        assert b.history_raw["round_clock"] == a.history_raw["round_clock"]
        assert a.report.times.t_com - b.report.times.t_com == pytest.approx(
            tcore.CadenceConfig().idle_step_s, abs=1e-12)


def test_two_requester_event_streams_match_across_engines_and_packages():
    """Through the facades, requester i ticks as ``requester_id + i`` in the
    port's loop runner as in its fleet and in the reference's loop runner:
    all three event streams are equal, and the two requesters keep their
    own clocks."""
    task, own_train, own_test, fleet, states = _problem()
    knobs = dict(desired_accuracy=0.99, max_rounds=3, epochs=1, batch_size=BATCH,
                 encrypt=False, contributor_refresh_epochs=1)
    cad = dict(n_speed_classes=2, duty_cycle=3, duty_on=2, seed=0)
    ttask, _, _, tfleet, states_fn = _port_world(False)
    tworld = WorldSpec(task=ttask, requesters=[
        tcore.RequesterSpec(own_train, own_test, tfleet, states_fn()) for _ in range(2)],
        device="cpu")
    tmethod = MethodSpec(cadence=tcore.CadenceConfig(**cad), **knobs)
    loop, fl = (Experiment(tworld, tmethod, ExecutionSpec(engine=e)).run()
                for e in ("loop", "fleet"))
    assert compare_event_streams(validate_events(loop.trace), validate_events(fl.trace)) == []
    clocks = [s.history_raw["round_clock"] for s in loop.sessions]
    assert clocks[0] != clocks[1], "the two requesters tick on their own clocks"
    with threefry(False):
        jworld = japi.WorldSpec(task=task, requesters=[
            jcore.RequesterSpec(own_train, own_test, fleet, copy.deepcopy(states))
            for _ in range(2)])
        ref = japi.Experiment(jworld, japi.MethodSpec(cadence=jcore.CadenceConfig(**cad),
                                                      **knobs),
                              japi.ExecutionSpec(engine="loop")).run()
    port = jtel.validate_events([jtel.RoundEvent(**ev.__dict__) for ev in loop.trace])
    assert jtel.compare_event_streams(jtel.validate_events(ref.trace), port) == []
