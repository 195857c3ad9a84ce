"""Contract-theory incentive mechanism (paper §III, [31]); copy of
``repro.core.incentive``: the static handshake for one requester
(:func:`select_contributors`, and its :func:`participation_mask` for the
LM trainer's clients) and for a fleet (:func:`sign_contracts_fleet`), and the
dynamic contracts of the mobility world (:func:`candidate_pool`,
:func:`contracts_from_membership`).

The requesting device publishes an offered incentive; each nearby device
has a private reservation price (its cost of participating: battery it
will burn, staleness of its model, data it holds).  A device agrees iff
the offer covers its reservation; the requester then ranks agreeing
devices by a contract utility (fresher model, more data, healthier
battery = better contribution per unit incentive) and signs contracts
with the top ``N_max``.

This module is deterministic given the fleet state + rng seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class NeighborDevice:
    device_id: int
    battery_level: float          # [0, 1]
    model_staleness: float        # rounds since the neighbour last updated (>=0)
    data_size: int                # samples backing its local model
    reservation_price: float      # minimum acceptable incentive
    has_model: bool = True        # neighbour actually has a model for app A


@dataclasses.dataclass(frozen=True)
class Contract:
    device_id: int
    incentive: float
    utility: float


def contract_utility(dev: NeighborDevice, max_data: int) -> float:
    """Value of a contribution: fresh, data-rich, battery-healthy models."""
    freshness = 1.0 / (1.0 + dev.model_staleness)
    data_term = dev.data_size / max(max_data, 1)
    battery_term = min(dev.battery_level / 0.5, 1.0)   # below 50% progressively risky
    return 0.5 * freshness + 0.3 * data_term + 0.2 * battery_term


def select_contributors(devices: Sequence[NeighborDevice], offered_incentive: float,
                        n_max: int, min_battery: float = 0.1) -> List[Contract]:
    """Handshaking phase of Algorithm 1: who agrees, and whom we sign.

    Returns contracts sorted by utility (best first), at most ``n_max``.
    """
    agreeing = [d for d in devices
                if d.has_model
                and d.battery_level >= min_battery
                and offered_incentive >= d.reservation_price]
    max_data = max((d.data_size for d in agreeing), default=1)
    ranked = sorted(agreeing, key=lambda d: -contract_utility(d, max_data))
    return [Contract(device_id=d.device_id, incentive=offered_incentive,
                     utility=contract_utility(d, max_data))
            for d in ranked[:n_max]]


def participation_mask(num_devices: int, contracts: Sequence[Contract]) -> np.ndarray:
    """(num_devices,) fp32: 1.0 at each contracted device id."""
    mask = np.zeros((num_devices,), np.float32)
    for c in contracts:
        mask[c.device_id] = 1.0
    return mask


def sign_contracts_fleet(neighborhoods: Sequence[Sequence[NeighborDevice]],
                         offered_incentive: float, n_max: int,
                         min_battery: float = 0.1):
    """Handshake phase for a whole fleet of requesters at once.

    ``neighborhoods[i]`` is requester *i*'s view of the device population.
    Returns ``(contracts, mask)``: ``contracts[i]`` is requester *i*'s
    ranked contract list and ``mask`` an (R, n_max) float32 matrix with
    1.0 at slot (i, j) iff requester *i* signed a j-th contributor (slot
    order is contract rank, the loop engine's aggregation order).
    """
    contracts = [select_contributors(devs, offered_incentive, n_max, min_battery)
                 for devs in neighborhoods]
    mask = np.zeros((len(contracts), n_max), np.float32)
    for i, cs in enumerate(contracts):
        mask[i, :len(cs)] = 1.0
    return contracts, mask


# ---------------------------------------------------------------------------
# dynamic contracts (the mobility world, repro_torch.core.mobility)
# ---------------------------------------------------------------------------


def candidate_pool(devices: Sequence[NeighborDevice],
                   offered_incentive: float) -> List[NeighborDevice]:
    """The agreeing devices of a neighbourhood, in stable device order.

    Under mobility the handshake fixes this pool instead of a contract set:
    every device that holds a model and whose reservation price the offer
    covers.  Battery and radio range are checked each round by
    :func:`repro_torch.core.mobility.membership_step`; the pool's order is
    the contributor lane order of both engines."""
    return [d for d in devices
            if d.has_model and offered_incentive >= d.reservation_price]


def contracts_from_membership(candidates: Sequence[NeighborDevice], member, util,
                              offered_incentive: float) -> List[Contract]:
    """Host view of one round's renegotiated contract set: ``member`` and
    ``util`` are one requester's (N,) outputs of ``membership_step``
    (tensors or arrays); returns the signed contracts, best utility first
    (equal utilities by lane index)."""
    member = np.asarray(torch.as_tensor(member).cpu(), bool)
    util = np.asarray(torch.as_tensor(util).cpu(), np.float32)
    order = sorted((j for j in range(len(candidates)) if member[j]),
                   key=lambda j: (-util[j], j))
    return [Contract(device_id=candidates[j].device_id,
                     incentive=offered_incentive, utility=float(util[j]))
            for j in order]


def make_fleet(num_devices: int, seed: int = 0, p_has_model: float = 0.9) -> List[NeighborDevice]:
    """Randomized nearby-device fleet for simulations."""
    rng = np.random.default_rng(seed)
    fleet = []
    for i in range(num_devices):
        fleet.append(NeighborDevice(
            device_id=i,
            battery_level=float(rng.uniform(0.15, 1.0)),
            model_staleness=float(rng.exponential(1.0)),
            data_size=int(rng.integers(200, 2000)),
            reservation_price=float(rng.uniform(0.2, 1.0)),
            has_model=bool(rng.random() < p_has_model),
        ))
    return fleet
