"""The two fault worlds of the reference's ``tests/test_adversary.py`` in
both engines of the port against the JAX package on the CPU: noise
contributors under the clip defense on the int8 wire, and a scale attack
under the median with staleness decay, both with unreliable links.  A
stale image is substituted first and then corrupted, keyed on the round
that delivers it; a corruption counts only where the link delivered.
Same runs and limits as ``tests/test_torch_faults_engines.py``, whose
helpers this file uses (its world table is this file's own)."""

import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_faults_engines import BATTERY_RTOL, _assert_matches, _masks, _run_world  # noqa: E402,I100

WORLDS = {
    "noise-clip-faults-int8": dict(adversary=dict(p_byzantine=0.5, attack="noise", scale=2.0,
                                                  seed=7), robust="clip", compress="int8"),
    "scale-median-decay": dict(adversary=dict(p_byzantine=0.5, attack="scale", scale=5.0,
                                              seed=7), robust="median", staleness_gamma=0.5),
}


@pytest.mark.parametrize("name", list(WORLDS))
def test_loop_engine_matches_jax_loop_engine(name):
    jloop, _, tloop, _ = _run_world(name, WORLDS)
    _assert_matches(jloop, tloop, over=WORLDS[name], battery_rtol=1e-12)


@pytest.mark.parametrize("name", list(WORLDS))
def test_fleet_matches_jax_fleet(name):
    _, jfleet, _, tfleet = _run_world(name, WORLDS)
    _assert_matches(jfleet, tfleet, over=WORLDS[name], battery_rtol=BATTERY_RTOL)


@pytest.mark.parametrize("name", list(WORLDS))
def test_port_fleet_matches_port_loop_engine(name):
    _, _, tloop, tfleet = _run_world(name, WORLDS)
    _assert_matches(tloop, tfleet, over=WORLDS[name], battery_rtol=BATTERY_RTOL)


@pytest.mark.parametrize("name", list(WORLDS))
def test_the_adversary_fires_on_delivered_links_only(name):
    _, _, tloop, tfleet = _run_world(name, WORLDS)
    for res in (tloop, tfleet):
        corrupted, delivered = _masks(res, "corrupted_mask"), _masks(res, "deliver_mask")
        assert corrupted.sum() > 0 and sum(res.history_raw["stale"]) > 0
        assert not (corrupted > delivered).any()
    assert _masks(tloop, "clipped_mask").shape[0] == tloop.rounds
