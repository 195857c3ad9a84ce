"""The port's opportunistic world (``repro_torch.core.mobility``) against
``repro.core.mobility`` on the CPU, with the dynamic contracts of
``repro_torch.core.incentive`` and the energy helpers the world
discharges by; then the twins of ``tests/test_mobility.py``'s unit cases.

Positions, in-range masks, memberships and ranks must match exactly, the
fp32 utilities and contributor batteries bit for bit, under both threefry
modes; the energy helpers to the reference's own float64 arithmetic.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import energy as jenergy  # noqa: E402
from repro.core import incentive as jinc  # noqa: E402
from repro.core import mobility as jmob  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import incentive as tinc  # noqa: E402
from repro_torch.core import mobility as tmob  # noqa: E402

from _torch_ref import threefry  # noqa: E402

WORLDS = {
    "waypoint": dict(radio_range_m=110.0, leg_rounds=2, seed=3),
    "churn-demo": dict(arena_m=200.0, radio_range_m=90.0, leg_rounds=2, seed=5),
    "long-legs": dict(arena_m=150.0, radio_range_m=60.0, leg_rounds=7, seed=11),
    "static": dict(mode="static", radio_range_m=80.0, seed=5),
}
# requesters (lane 0 and 1 of a fleet) and candidates: small ids, ids past
# 2**20 (the requester space) and one near the int32 edge
REQ = np.array([1 << 20, (1 << 20) + 1], np.int64)
IDS = np.array([[0, 1, 2, 3, 4, 97], [7, (1 << 20) + 5, 2**31 - 2, 12, 2, 1 << 22]], np.int64)


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def threefry_mode(request):
    with threefry(request.param):
        yield request.param


def _pair(**kw):
    return jmob.MobilityConfig(**kw), tmob.MobilityConfig(**kw)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the world functions against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", list(WORLDS))
def test_positions_and_in_range_masks_match_jax(world, threefry_mode):
    jm, tm = _pair(**WORLDS[world])
    j_mask = jax.jit(lambda r: jmob.in_range_mask(jm, REQ.astype(np.int32),
                                                  IDS.astype(np.int32), r))
    j_pos = jax.jit(lambda r: jmob.device_positions(jm, IDS.astype(np.int32), r))
    assert tm._range2_units == jm._range2_units
    flips = 0
    prev = None
    for r in range(41):
        want = np.asarray(j_mask(np.int32(r)))
        got = tmob.in_range_mask(tm, _t(REQ), _t(IDS), r, partitionable=threefry_mode)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want), r
        pos = tmob.device_positions(tm, IDS, r, partitionable=threefry_mode)
        assert np.array_equal(pos.numpy(), np.asarray(j_pos(np.int32(r)))), r
        # one requester as an int against an (N,) row: the loop engine's call
        one = tmob.in_range_mask(tm, int(REQ[1]), _t(IDS[1]), r, partitionable=threefry_mode)
        assert np.array_equal(one.numpy(), want[1])
        flips += prev is not None and not np.array_equal(prev, want)
        prev = want
    if WORLDS[world].get("mode") != "static":
        assert flips > 0, "the world must move"


def test_trajectory_and_one_position_match_jax(threefry_mode):
    jm, tm = _pair(**WORLDS["long-legs"])
    for dev in (0, 3, 1 << 20):
        want = np.asarray(jmob.trajectory(jm, dev, 16))
        got = tmob.trajectory(tm, dev, 16, partitionable=threefry_mode)
        assert got.shape == (16, 2) and np.array_equal(got.numpy(), want)
        assert np.array_equal(tmob.device_position(tm, dev, 9, partitionable=threefry_mode)
                              .numpy(), np.asarray(jmob.device_position(jm, dev, 9)))


def _grid(rng, r, n):
    """A random (R, N) renegotiation input with ties in the utilities (a
    few distinct values), batteries at and around the floor, padding."""
    base = rng.choice(np.float32([0.1, 0.3, 0.45, 0.6, 0.8]), size=(r, n)).astype(np.float32)
    level = rng.choice(np.float32([0.0, 0.05, 0.1, 0.25, 0.5, 0.75, 1.0]),
                       size=(r, n)).astype(np.float32)
    mask = rng.random((r, n)) < 0.85
    ids = rng.integers(0, 40, (r, n)).astype(np.int64)
    return base, level, mask, ids


@pytest.mark.parametrize("world", ["waypoint", "static", "everyone"])
def test_membership_step_matches_jax(world, threefry_mode):
    """Member and rank exact, util bitwise, on (R, N) grids with ties, floor
    releases (levels at and under 0.1) and undercuts (more eligible
    candidates than slots), and on one requester's (N,) row."""
    kw = (dict(mode="static", radio_range_m=1e6, seed=1) if world == "everyone"
          else WORLDS[world])
    jm, tm = _pair(**kw)
    rng = np.random.default_rng(7)
    req = np.arange(4, dtype=np.int64) + (1 << 20)
    undercuts = releases = 0
    for trial in range(6):
        base, level, mask, ids = _grid(rng, 4, 7)
        for r in (0, 1, 5):
            n_max = 1 + trial % 3
            want = jmob.membership_step(jm, r, req.astype(np.int32), ids.astype(np.int32),
                                        mask, base, level, n_max)
            got = tmob.membership_step(tm, r, _t(req), _t(ids), _t(mask), _t(base), _t(level),
                                       n_max, partitionable=threefry_mode)
            member, rank, util = (np.asarray(w) for w in want)
            assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
            assert np.array_equal(got[0].numpy(), member)
            assert np.array_equal(got[1].numpy(), rank)
            assert np.array_equal(got[2].numpy().view(np.int32), util.view(np.int32))
            row = tmob.membership_step(tm, r, int(req[2]), _t(ids[2]), _t(mask[2]), _t(base[2]),
                                       _t(level[2]), n_max, partitionable=threefry_mode)
            assert np.array_equal(row[0].numpy(), member[2])
            eligible = mask & (level >= np.float32(0.1))
            undercuts += int((eligible & ~member & (rank >= n_max)).sum())
            releases += int((mask & (level < np.float32(0.1))).sum())
    assert releases > 0
    if world == "everyone":
        assert undercuts > 0


def test_membership_step_with_blocked_links_matches_jax():
    jm, tm = _pair(**WORLDS["waypoint"])
    base, level, mask, ids = _grid(np.random.default_rng(3), 2, 6)
    blocked = np.random.default_rng(4).random((2, 6)) < 0.3
    for r in range(4):
        want = jmob.membership_step(jm, r, REQ.astype(np.int32), ids.astype(np.int32), mask,
                                    base, level, 2, blocked=blocked)
        got = tmob.membership_step(tm, r, _t(REQ), _t(ids), _t(mask), _t(base), _t(level), 2,
                                   blocked=_t(blocked))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


def test_utility_terms_match_jax_bitwise():
    rng = np.random.default_rng(11)
    staleness = rng.exponential(1.0, 64).astype(np.float32)
    data = rng.integers(200, 2000, 64).astype(np.float32)
    want = np.asarray(jmob.static_utility_term(staleness, data, np.float32(data.max())))
    got = tmob.static_utility_term(staleness, data, np.float32(data.max())).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    level = np.concatenate([rng.random(60), [0.0, 0.5, 0.4999999, 1.0]]).astype(np.float32)
    assert np.array_equal(tmob.battery_utility_term(level).numpy().view(np.int32),
                          np.asarray(jmob.battery_utility_term(level)).view(np.int32))


def test_contributor_discharge_matches_jax_bitwise():
    rng = np.random.default_rng(5)
    level = rng.random((3, 5)).astype(np.float32)
    member = rng.random((3, 5)) < 0.6
    e_tx = rng.random((3, 5)).astype(np.float32) * 3.0
    e_ref = rng.random((3, 5)).astype(np.float32) * 40.0
    for refresh_on in (True, False, np.array([[True], [False], [True]])):
        for cap in (40e3, 0.004, 7.5):
            want = np.asarray(jmob.contributor_discharge(level, member, e_tx, e_ref,
                                                         refresh_on, cap))
            got = tmob.contributor_discharge(_t(level), _t(member), _t(e_tx), _t(e_ref),
                                             torch.as_tensor(refresh_on), cap).numpy()
            assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # drained to the floor of 0, never below
    assert float(tmob.contributor_discharge(_t(level), _t(member), _t(e_tx), _t(e_ref),
                                            True, 1e-6).min()) == 0.0


@pytest.mark.parametrize("encrypt", [True, False])
@pytest.mark.parametrize("num_params,model_bytes", [(18_566, 74_264), (2_821, 11_284),
                                                    (18_566, 20_000)])
def test_energy_helpers_match_jax(encrypt, num_params, model_bytes):
    jc, tc = jenergy.CostModel(), tenergy.CostModel()
    for n, refresh in ((512, 1), (93, 0), (1907, 3)):
        want = jc.contributor_round_energy(num_params=num_params, model_bytes=model_bytes,
                                           num_samples=n, refresh_epochs=refresh,
                                           encrypt=encrypt)
        got = tc.contributor_round_energy(num_params=num_params, model_bytes=model_bytes,
                                          num_samples=n, refresh_epochs=refresh,
                                          encrypt=encrypt)
        assert got == pytest.approx(want, rel=1e-15, abs=0)
    kw = dict(max_contrib=5, num_params=num_params, model_bytes=model_bytes,
              num_samples=480, epochs=8, n_devices=5, encrypt=encrypt)
    want, got = jc.round_energy_table(**kw), tc.round_energy_table(**kw)
    assert len(got) == 6 and got == pytest.approx(want, rel=1e-15, abs=0)
    # entry j is the static path's round energy at j contributors
    assert got[3] == tc.round_energy(n_contrib=3, num_params=num_params,
                                     model_bytes=model_bytes, num_samples=480, epochs=8,
                                     n_devices=5, encrypt=encrypt)


def _fleet(mod, seed):
    fleet = mod.make_fleet(8, seed=seed, p_has_model=0.7)
    for i, d in enumerate(fleet):
        d.reservation_price = (0.3, 0.5, 0.7)[i % 3]
    return fleet


@pytest.mark.parametrize("offer", [0.4, 0.6, 0.8])
def test_candidate_pool_and_contracts_match_jax(offer):
    for seed in (1, 2, 3):
        jf, tf = _fleet(jinc, seed), _fleet(tinc, seed)
        jp, tp = jinc.candidate_pool(jf, offer), tinc.candidate_pool(tf, offer)
        assert [d.device_id for d in tp] == [d.device_id for d in jp]
        if not tp:
            continue
        n = len(tp)
        rng = np.random.default_rng(seed)
        member = rng.random(n) < 0.6
        util = rng.choice(np.float32([0.2, 0.5, 0.7]), n).astype(np.float32)  # ties
        want = jinc.contracts_from_membership(jp, member, util, offer)
        for m, u in ((member, util), (_t(member), _t(util))):
            got = tinc.contracts_from_membership(tp, m, u, offer)
            assert [(c.device_id, c.incentive, c.utility) for c in got] == \
                [(c.device_id, c.incentive, c.utility) for c in want]


# ---------------------------------------------------------------------------
# twins of tests/test_mobility.py
# ---------------------------------------------------------------------------


def test_positions_inside_arena_and_deterministic():
    mob = tmob.MobilityConfig(arena_m=150.0, leg_rounds=3, seed=11)
    traj = tmob.trajectory(mob, 7, 20)
    assert traj.shape == (20, 2)
    assert bool((traj >= 0.0).all()) and bool((traj <= 150.0).all())
    assert torch.equal(traj, tmob.trajectory(mob, 7, 20))


def test_static_mode_pins_devices():
    traj = tmob.trajectory(tmob.MobilityConfig(mode="static", seed=5), 3, 12)
    assert bool((traj == traj[0]).all())


def test_waypoint_interpolation_hits_leg_endpoints():
    """Round k * leg_rounds sits on waypoint k; in between the device moves
    linearly."""
    traj = tmob.trajectory(tmob.MobilityConfig(leg_rounds=4, seed=2), 9, 13).numpy()
    w0, w4, w8 = traj[0], traj[4], traj[8]
    np.testing.assert_allclose(traj[2], 0.5 * (w0 + w4), rtol=1e-5)
    np.testing.assert_allclose(traj[6], 0.5 * (w4 + w8), rtol=1e-5)
    assert not np.allclose(w0, w4), "waypoints differ"


def test_fleet_grid_matches_per_requester_rows():
    """The fleet calls the world on (R, N) grids, the loop engine one
    requester's (N,) row at a time: the same masks, the keystone of parity
    between the engines."""
    mob = tmob.MobilityConfig(radio_range_m=100.0, leg_rounds=3, seed=9)
    ids = torch.arange(24).reshape(4, 6)
    req = torch.arange(4) + mob.requester_id
    for r in (0, 1, 5, 11):
        grid = tmob.in_range_mask(mob, req, ids, r)
        rows = torch.stack([tmob.in_range_mask(mob, int(req[i]), ids[i], r) for i in range(4)])
        assert torch.equal(grid, rows)


def test_positions_prefix_stable_under_device_padding():
    mob = tmob.MobilityConfig(seed=4)
    small = tmob.device_positions(mob, np.arange(3), 6)
    big = tmob.device_positions(mob, np.arange(8), 6)
    assert torch.equal(small, big[:3])


def _membership(mob, r, ids, level, base_util, n_max, cand_mask=None):
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64)
    cand_mask = torch.ones(ids.shape, dtype=torch.bool) if cand_mask is None else _t(cand_mask)
    member, rank, util = tmob.membership_step(
        mob, r, mob.requester_id, ids, cand_mask, _t(np.asarray(base_util, np.float32)),
        _t(np.asarray(level, np.float32)), n_max)
    return member.numpy(), rank.numpy(), util.numpy()


def test_membership_caps_at_n_max_by_utility():
    mob = tmob.MobilityConfig(mode="static", radio_range_m=1e6, seed=0)
    base = np.array([0.3, 0.5, 0.1, 0.9], np.float32)
    member, rank, _ = _membership(mob, 0, np.arange(4), np.ones(4), base, 2)
    assert member.tolist() == [False, True, False, True]
    assert rank[3] == 0 and rank[1] == 1


def test_membership_releases_below_battery_floor():
    mob = tmob.MobilityConfig(mode="static", radio_range_m=1e6, seed=0, battery_floor=0.25)
    base = np.array([0.9, 0.8, 0.7], np.float32)
    member, _, _ = _membership(mob, 0, np.arange(3), [0.2, 0.9, 0.9], base, 3)
    assert member.tolist() == [False, True, True]


def test_membership_undercut_by_higher_utility_arrival():
    mob = tmob.MobilityConfig(mode="static", radio_range_m=1e6, seed=0)
    base = np.array([0.4, 0.5, 0.95], np.float32)
    m0, _, _ = _membership(mob, 0, np.arange(3), [0.9, 0.9, 0.0], base, 2)
    assert m0.tolist() == [True, True, False]
    m1, _, _ = _membership(mob, 0, np.arange(3), [0.9, 0.9, 0.9], base, 2)
    assert m1.tolist() == [False, True, True]


def test_membership_prefix_stable_under_candidate_padding():
    mob = tmob.MobilityConfig(radio_range_m=120.0, leg_rounds=2, seed=3)
    base = np.array([0.6, 0.4, 0.8], np.float32)
    level = np.array([0.9, 0.8, 0.7], np.float32)
    for r in range(6):
        m_small, _, _ = _membership(mob, r, np.arange(3), level, base, 2)
        m_big, _, _ = _membership(
            mob, r, np.arange(6), np.concatenate([level, np.ones(3, np.float32)]),
            np.concatenate([base, np.full(3, 99.0, np.float32)]), 2,
            cand_mask=np.array([1, 1, 1, 0, 0, 0], bool))
        assert np.array_equal(m_small, m_big[:3])
        assert not m_big[3:].any()


def test_membership_ties_break_by_lane_index():
    mob = tmob.MobilityConfig(mode="static", radio_range_m=1e6, seed=0)
    member, rank, _ = _membership(mob, 0, np.arange(4), np.ones(4), np.full(4, 0.5), 2)
    assert member.tolist() == [True, True, False, False]
    assert rank.tolist() == [0, 1, 2, 3]


def test_membership_events_counts_joins_and_leaves():
    trace = np.array([[1, 1, 0], [1, 0, 1], [1, 0, 1], [0, 0, 1]], bool)
    assert tmob.membership_events(trace) == (1, 2)
    assert tmob.membership_events(trace[:1]) == (0, 0)


def test_mobility_config_validation():
    with pytest.raises(AssertionError):
        tmob.MobilityConfig(mode="teleport")
    with pytest.raises(AssertionError):
        tmob.MobilityConfig(leg_rounds=0)
    with pytest.raises(AssertionError):
        tmob.MobilityConfig(leg_rounds=65)

