"""Opportunistic world: device mobility, radio-range neighbour discovery
and per-round contract renegotiation, shared by both engines (port of
``repro.core.mobility``).

* **Counter-based kinematics.**  Every device walks a discretised
  random-waypoint trajectory: time is split into legs of ``leg_rounds``
  rounds, waypoint ``k`` of device ``d`` is the draw
  ``randint(fold_in(fold_in(PRNGKey(seed), d), k), (2,), 0, GRID)`` of
  :mod:`repro_torch.core.prng` (bit-exact with ``jax.random``), and the
  position at round ``r`` interpolates the leg's endpoints.  Positions are
  a closed form of ``(seed, round, device)``, so the loop engine (on the
  host) and the fleet engine (on its device) derive the same world, and
  any round can be queried without replaying the earlier ones.
  ``mode="static"`` pins every device to its waypoint 0.
* **Radio-range discovery** (:func:`in_range_mask`): exact integer
  squared distances on the scaled lattice against ``radio_range_m``.
* **Renegotiation** (:func:`membership_step`): candidates out of range or
  below the battery floor are released, in-range arrivals are signed, and
  when more candidates are eligible than ``n_max`` slots the requester
  keeps the top ``n_max`` by contract utility, so a higher-utility arrival
  displaces the weakest member.

The proximity predicate never touches a float: lattice coordinates are
int32 values scaled by ``leg_rounds`` so leg interpolation is exact, and
the squared distances are compared in integers.  The utilities are fp32
expressions with no multiply-add chain (each constant is an fp32 value,
each operation rounds once), so both engines, and the reference, agree on
every bit of them.  Every function takes tensors of any leading shape,
(N,) for one session or (R, N) for a fleet, on any device; every draw
takes the threefry mode (``partitionable``) explicitly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng

# Waypoints are drawn on a GRID x GRID integer lattice; positions are
# lattice coordinates scaled by ``leg_rounds`` (exact interpolation).
GRID = 512


def _f32(x: float) -> float:
    """``x`` rounded to fp32, as a Python float: a float32 tensor times it
    rounds once, to the fp32 product."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class MobilityConfig:
    """World parameters for one simulated session.

    ``requester_id`` is the requesting device's id in the kinematics
    hash-space; fleet lanes use ``requester_id + lane`` so concurrent
    requesters walk distinct trajectories.  The default offset keeps it
    clear of contributor ids.
    """

    mode: str = "waypoint"            # "waypoint" | "static"
    arena_m: float = 200.0            # square world side length (meters)
    radio_range_m: float = 80.0       # contract-eligible iff dist <= range
    leg_rounds: int = 4               # rounds per random-waypoint leg
    seed: int = 0                     # kinematics hash seed
    requester_id: int = 1 << 20       # requester lane 0's device id
    battery_floor: float = 0.1        # contributors below this are released
    contributor_capacity_j: float = 40e3  # battery capacity backing level

    def __post_init__(self):
        assert self.mode in ("waypoint", "static"), self.mode
        # scaled coordinates stay below GRID * leg_rounds; 64 keeps the
        # squared distance inside int32, as the reference requires
        assert 1 <= self.leg_rounds <= 64

    @property
    def _range2_units(self) -> int:
        """Radio range squared on the scaled lattice, clamped to int32 (a
        range covering the arena's diagonal is everyone)."""
        units = self.radio_range_m / self.arena_m * GRID * self.leg_rounds
        return min(int(units * units), 2**31 - 1)


def _waypoint_units(seed: int, device_id, k, *, partitionable: bool = True):
    """Waypoint ``k`` of ``device_id`` (broadcasting int64 tensors or ints):
    int64 lattice points of shape ``broadcast(device_id, k) + (2,)`` in
    [0, GRID)."""
    dev_t = torch.as_tensor(device_id, dtype=torch.int64)
    k_t = torch.as_tensor(k, dtype=torch.int64, device=dev_t.device)
    dev_t, k_t = torch.broadcast_tensors(dev_t, k_t)
    key = prng.fold_in(prng.fold_in(prng.prng_key(seed, device=dev_t.device), dev_t), k_t)
    return prng.randint(key, (2,), 0, GRID, partitionable=partitionable)


def _position_units(mob: MobilityConfig, device_id, r, *, partitionable: bool = True):
    """The scaled lattice positions ``device_id.shape + (2,)`` (int64) at
    round ``r``: the coordinates both engines compare distances in."""
    L = mob.leg_rounds
    ids = torch.as_tensor(device_id, dtype=torch.int64)
    if mob.mode == "static":
        return _waypoint_units(mob.seed, ids, 0, partitionable=partitionable) * L
    r = int(r)
    leg, m = r // L, r % L
    # both endpoints of the leg in one batch of draws
    ends = _waypoint_units(mob.seed, ids[..., None],
                           torch.tensor([leg, leg + 1], dtype=torch.int64, device=ids.device),
                           partitionable=partitionable)
    return ends[..., 0, :] * (L - m) + ends[..., 1, :] * m


def device_position(mob: MobilityConfig, device_id, r, *,
                    partitionable: bool = True) -> torch.Tensor:
    """(2,) fp32 position in meters of one device at round ``r``: the
    display view of the exact lattice coordinate."""
    scale = _f32(float(mob.arena_m) / (GRID * mob.leg_rounds))
    pos = _position_units(mob, device_id, r, partitionable=partitionable)
    return pos.to(torch.float32) * scale


def device_positions(mob: MobilityConfig, device_ids, r, *,
                     partitionable: bool = True) -> torch.Tensor:
    """Positions (meters) of an id tensor at round ``r``: ids shape + (2,)."""
    return device_position(mob, torch.as_tensor(device_ids, dtype=torch.int64), r,
                           partitionable=partitionable)


def trajectory(mob: MobilityConfig, device_id, rounds: int, *,
               partitionable: bool = True) -> torch.Tensor:
    """(rounds, 2) trajectory in meters: diagnostics and tests."""
    return torch.stack([device_position(mob, device_id, r, partitionable=partitionable)
                        for r in range(rounds)])


def in_range_mask(mob: MobilityConfig, requester_id, cand_ids, r, *,
                  partitionable: bool = True) -> torch.Tensor:
    """(..., N) bool: candidate within ``radio_range_m`` of its requester at
    round ``r``.  ``requester_id`` (an int or a tensor of the leading
    shape) broadcasts against ``cand_ids`` ((N,) or (R, N)); the result lies
    on ``cand_ids``' device.  Requesters and candidates are drawn in one
    batch; the squared distances are exact integers."""
    ids = torch.as_tensor(cand_ids, dtype=torch.int64)
    req = torch.as_tensor(requester_id, dtype=torch.int64, device=ids.device)
    req_shape = req.shape
    flat = torch.cat([req.reshape(-1), ids.reshape(-1)])
    pos = _position_units(mob, flat, r, partitionable=partitionable)
    n_req = req.numel()
    req_pos = pos[:n_req].reshape(req_shape + (2,))
    cand_pos = pos[n_req:].reshape(ids.shape + (2,))
    d = cand_pos - req_pos[..., None, :]
    dist2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    return dist2 <= mob._range2_units


def battery_utility_term(level) -> torch.Tensor:
    """The dynamic slice of the contract utility: ``min(level * 0.4, 0.2)``
    in fp32, one rounding per operation."""
    level = torch.as_tensor(level, dtype=torch.float32)
    return torch.clamp_max(level * _f32(0.4), _f32(0.2))


def static_utility_term(staleness, data_size, max_data) -> torch.Tensor:
    """The round-invariant slice of the contract utility, freshness and data
    richness, ``0.5 / (1 + staleness) + 0.3 * data / max(max_data, 1)``
    in fp32 (each product rounded before the sum, no fused multiply-add)."""
    staleness = torch.as_tensor(staleness, dtype=torch.float32)
    data = torch.as_tensor(data_size, dtype=torch.float32, device=staleness.device)
    max_data = torch.as_tensor(max_data, dtype=torch.float32, device=staleness.device)
    freshness = 1.0 / (1.0 + staleness)
    data_term = data / torch.clamp_min(max_data, 1.0)
    return _f32(0.5) * freshness + _f32(0.3) * data_term


def membership_step(mob: MobilityConfig, r, requester_id, cand_ids, cand_mask,
                    base_util, level, n_max: int, blocked=None, *,
                    partitionable: bool = True):
    """One round of contract renegotiation, shared by both engines.

    ``requester_id`` (an int or (R,)), ``cand_ids`` (..., N) candidate
    device ids, ``cand_mask`` (..., N) real candidate lanes (the pool is
    the agreeing devices, padding False), ``base_util`` (..., N) fp32
    static utility, ``level`` (..., N) fp32 contributor battery fractions,
    ``n_max`` contract slots, ``blocked`` optional (..., N) links the fault
    world suspends (treated as out of range).  Tensors lie on one device.

    Returns ``(member, rank, util)``: the renegotiated contract set
    (eligible and among the top ``n_max`` by utility), each lane's rank
    among the eligible candidates (0 = best, equal utilities broken by the
    lower lane index) as int32, and the fp32 utilities."""
    cand_ids = torch.as_tensor(cand_ids, dtype=torch.int64)
    dev = cand_ids.device
    cand_mask = torch.as_tensor(cand_mask, device=dev).to(torch.bool)
    level = torch.as_tensor(level, dtype=torch.float32, device=dev)
    base_util = torch.as_tensor(base_util, dtype=torch.float32, device=dev)
    eligible = (cand_mask
                & in_range_mask(mob, requester_id, cand_ids, r, partitionable=partitionable)
                & (level >= _f32(mob.battery_floor)))
    if blocked is not None:
        eligible = eligible & ~torch.as_tensor(blocked, device=dev).to(torch.bool)
    util = base_util + battery_utility_term(level)
    n = util.shape[-1]
    # rank = how many eligible candidates beat me: a higher utility, or an
    # equal one at a lower lane index (pure comparisons, O(N^2) on a table)
    uk, uj = util[..., None, :], util[..., :, None]
    lane = torch.arange(n, device=dev)
    beats = (uk > uj) | ((uk == uj) & (lane[None, :] < lane[:, None]))
    rank = torch.sum(beats & eligible[..., None, :], dim=-1).to(torch.int32)
    member = eligible & (rank < n_max)
    return member, rank, util


def contributor_discharge(level, member, e_tx, e_refresh, refresh_on,
                          capacity_j: float) -> torch.Tensor:
    """Contributor battery fractions after one round: members pay
    ``e_tx``, and ``e_refresh`` where ``refresh_on`` (the requester's
    session goes on), ``max(level - drain * pay / capacity, 0)`` in fp32."""
    level = torch.as_tensor(level, dtype=torch.float32)
    dev = level.device
    pay = torch.as_tensor(member, device=dev).to(torch.float32)
    e_tx = torch.as_tensor(e_tx, dtype=torch.float32, device=dev)
    e_refresh = torch.as_tensor(e_refresh, dtype=torch.float32, device=dev)
    refresh_on = torch.as_tensor(refresh_on, device=dev).to(torch.bool)
    drain = e_tx + torch.where(refresh_on, e_refresh, torch.zeros_like(e_refresh))
    return torch.clamp_min(level - drain * pay / _f32(capacity_j), 0.0)


def membership_events(member_trace):
    """``(joins, leaves)`` of a (rounds, ..., N) membership trace, summed
    over rounds 1 to the end (round 0's signing counts as neither)."""
    m = np.asarray(member_trace, bool)
    if m.shape[0] < 2:
        return 0, 0
    diff = m[1:].astype(np.int8) - m[:-1].astype(np.int8)
    return int((diff > 0).sum()), int((diff < 0).sum())
