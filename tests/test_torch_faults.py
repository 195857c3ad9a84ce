"""The port's unreliable-link world functions against the JAX package's
(``repro.core.faults``) on the CPU: ``FaultConfig``'s validation, the
per-link outcomes and the blocked streaks bit for bit under both threefry
modes (negative rounds included, which ``blocked_mask`` evaluates early in
a session), the fleet's one-batch staging against round-by-round draws,
and ``CostModel.retry_energy`` to the float."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import energy as jenergy  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402

from _torch_ref import threefry  # noqa: E402

# all three failure modes and a blocked streak within a few rounds
WORLD = dict(p_drop=0.6, p_stale=0.4, max_retries=2, release_after=2, seed=3)
# contributor ids as both engines hold them, with the int32 extremes
IDS = np.array([0, 3, 5, 7, 1000, 2**31 - 1], np.int32)


def _both(**kw):
    return jfaults.FaultConfig(**kw), tfaults.FaultConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(p_drop=-0.1), dict(p_drop=1.5), dict(p_stale=2.0), dict(p_stale=-1e-9),
    dict(max_retries=-1), dict(release_after=-2)])
def test_fault_config_validation(kw):
    for cls in (jfaults.FaultConfig, tfaults.FaultConfig):
        with pytest.raises(ValueError):
            cls(**kw)


def test_fault_config_defaults_and_budget():
    jfc, tfc = _both()
    assert dataclasses.asdict(jfc) == dataclasses.asdict(tfc)
    assert tfaults.FaultConfig(p_drop=1.0, max_retries=0).attempts_max == 1
    assert tfc.attempts_max == jfc.attempts_max == 3
    hash(tfc)                                     # frozen, as the reference's


@pytest.mark.parametrize("p", [0.0, 0.3, 0.6, 1.0 / 3, 0.999999999, 1.0])
def test_threshold_is_the_float64_product(p):
    assert tfaults._threshold(p) == int(jfaults._threshold(p))


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("r", [-3, -1, 0, 1, 7])
def test_link_outcomes_and_blocked_mask_bit_exact(partitionable, r):
    jfc, tfc = _both(**WORLD)
    ids = torch.from_numpy(IDS.astype(np.int64))
    with threefry(partitionable):
        want = [np.asarray(v) for v in jfaults.link_outcomes(jfc, jnp.int32(r),
                                                             jfc.requester_id, IDS)]
        want_blocked = np.asarray(jfaults.blocked_mask(jfc, r, jfc.requester_id, IDS))
    got = tfaults.link_outcomes(tfc, r, tfc.requester_id, ids, partitionable=partitionable)
    for w, g in zip(want, got):
        assert np.array_equal(w, g.numpy())
    blocked = tfaults.blocked_mask(tfc, r, tfc.requester_id, ids, partitionable=partitionable)
    assert np.array_equal(want_blocked, blocked.numpy())
    if r < WORLD["release_after"]:
        assert not blocked.any()                  # no fault history before round 0


@pytest.mark.parametrize("partitionable", [True, False])
def test_fleet_staging_matches_round_by_round_draws(partitionable):
    """The fleet stages every round of every lane in one batch (a tensor of
    rounds); lane i rolls as requester ``requester_id + i``.  Each round
    equals the reference's own per-round draw and ``blocked_mask``."""
    jfc, tfc = _both(**WORLD)
    R, rounds = 3, 6
    req = np.arange(R, dtype=np.int32) + jfc.requester_id
    cand = np.stack([IDS] * R)
    r_all = torch.arange(rounds)
    req_t, cand_t = torch.from_numpy(req.astype(np.int64)), torch.from_numpy(cand.astype(np.int64))
    got = (*tfaults.link_outcomes(tfc, r_all, req_t, cand_t, partitionable=partitionable),
           tfaults.blocked_mask(tfc, r_all, req_t, cand_t, partitionable=partitionable))
    assert all(t.shape == (rounds, R, len(IDS)) for t in got)
    with threefry(partitionable):
        for r in range(rounds):
            want = [np.asarray(v) for v in jfaults.link_outcomes(jfc, r, req, cand)]
            want.append(np.asarray(jfaults.blocked_mask(jfc, r, req, cand)))
            for w, g in zip(want, got):
                assert np.array_equal(w, g[r].numpy()), r
    delivered, attempts, stale, blocked = (t.numpy() for t in got)
    assert stale.any() and blocked.any() and (~delivered).any()
    assert (attempts[delivered] <= tfc.attempts_max).all()
    assert (attempts[~delivered] == tfc.attempts_max).all()
    assert not (stale & ~delivered).any()
    # other requesters see other link weather
    assert not np.array_equal(delivered[:, 0], delivered[:, 1])


def test_release_after_zero_never_blocks():
    tfc = tfaults.FaultConfig(p_drop=0.9, max_retries=0, release_after=0, seed=1)
    ids = torch.arange(8)
    assert not tfaults.blocked_mask(tfc, 5, 7, ids).any()
    assert not tfaults.blocked_mask(tfc, torch.arange(4), 7, ids).any()


@pytest.mark.parametrize("kw", [
    dict(model_bytes=74264), dict(model_bytes=19536, encrypt=False),
    dict(model_bytes=74264, encrypt=True, rate_bps=12e6), dict(model_bytes=1)])
def test_retry_energy_equals_the_reference_to_the_float(kw):
    assert tenergy.CostModel().retry_energy(**kw) == jenergy.CostModel().retry_energy(**kw)
