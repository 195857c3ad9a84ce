"""The port's two engines in the asynchronous-cadence worlds of
``tests/test_cadence.py`` that compose with another world (faults,
mobility), against the JAX package's two engines on the CPU, on the
helpers and limits of ``tests/test_torch_cadence_engines.py``.  The worlds
coupled to the battery (pacing) or decaying a lagging image
(``staleness_gamma < 1``), and the facades' streams, run in
``tests/test_torch_cadence_coupled.py``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402

from test_torch_cadence_engines import PAIRS, WORLDS, _run_world, check_pair, check_tick_sets  # noqa: E402

COMPOSED_WORLDS = ["faults", "mobility"]


@pytest.mark.parametrize("name", COMPOSED_WORLDS)
@pytest.mark.parametrize("pair", PAIRS)
def test_port_engines_match_the_reference_engines(name, pair):
    check_pair(name, pair)


@pytest.mark.parametrize("name", COMPOSED_WORLDS)
def test_port_tick_sets_are_the_reference_ticks(name):
    check_tick_sets(name)


def test_the_worlds_exercise_what_they_name():
    """Mobility keys on the step with the requester on stride 2, and the
    fault weather keys on the event step each round ran at (the
    reference's own assertions, on the port)."""
    _, _, mob, _ = _run_world("mobility")
    assert mob.history_raw["round_clock"] == [1, 3, 5]
    _, _, faulty, _ = _run_world("faults")
    fc = tcore.FaultConfig(**WORLDS["faults"][1]["faults"])
    ids = np.arange(3, dtype=np.int64)
    for t, got in zip(faulty.history_raw["round_clock"], faulty.history_raw["deliver_mask"]):
        delivered, _, _ = tfaults.link_outcomes(fc, t, fc.requester_id, ids, partitionable=False)
        blocked = tfaults.blocked_mask(fc, t, fc.requester_id, ids, partitionable=False)
        assert np.array_equal(np.asarray(got) > 0, (delivered & ~blocked).numpy())
    assert sum(faulty.history_raw["stale"]) + sum(faulty.history_raw["drops"]) > 0
