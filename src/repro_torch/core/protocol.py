"""EnFed protocol vocabulary, shared by both engines (port of
``repro.core.protocol``): the phases of Algorithm 1, which of them each
method runs, stop reasons, and per-round aggregation weights.

Every method the fleet engine runs is a subset of the same phases:

* ``enfed`` — the full Algorithm-1 round (requester-side aggregation,
  contributor refresh, battery accounting);
* ``dfl`` — decentralized FedAvg: every client fits its own shard from its
  own params, then gossip-mixes over the mesh or ring (AGGREGATE is the
  mixing step); no refresh, no battery;
* ``cfl`` — centralized FedAvg: every client fits from the shared global,
  and a server-side data-size-weighted FedAvg replaces it.

The loop learners (:class:`repro_torch.core.federated.CFLLearner`,
``DFLLearner``) are the oracles of the two baseline variants, as
``EnFedSession`` is of enfed.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class Phase(enum.Enum):
    """The protocol phases of Algorithm 1 / eq. (4), in execution order."""

    HANDSHAKE = "handshake"      # contract selection + AES key exchange
    RENEGOTIATE = "renegotiate"  # mobility: per-round contract churn
    COLLECT = "collect"          # receive (and decrypt) contributor updates
    DELIVER = "deliver"          # faults: which collected updates arrived
    AGGREGATE = "aggregate"      # eq. (14) masked FedAvg, or the robust statistic
    FIT = "fit"                  # requester personalizes on its own shard
    SCORE = "score"              # evaluate against the desired accuracy A_A
    ACCOUNT = "account"          # eq. (4)-(7) cost roll-up + battery discharge
    REFRESH = "refresh"          # contributors keep training between rounds


ROUND_PHASES = (Phase.RENEGOTIATE, Phase.COLLECT, Phase.DELIVER,
                Phase.AGGREGATE, Phase.FIT, Phase.SCORE, Phase.ACCOUNT,
                Phase.REFRESH)

FLEET_METHODS = ("enfed", "dfl", "cfl")

_METHOD_PHASES = {
    "enfed": ROUND_PHASES,
    "dfl": (Phase.COLLECT, Phase.AGGREGATE, Phase.FIT, Phase.SCORE,
            Phase.ACCOUNT),
    "cfl": (Phase.COLLECT, Phase.AGGREGATE, Phase.FIT, Phase.SCORE,
            Phase.ACCOUNT),
}


def method_phases(method: str):
    """The protocol phases live for ``method``."""
    if method not in _METHOD_PHASES:
        raise ValueError(
            f"unknown fleet method {method!r}; one of {FLEET_METHODS}")
    return _METHOD_PHASES[method]


# Stop reasons as small ints; order encodes check priority (accuracy is
# tested before battery).
STOP_MAX_ROUNDS = 0
STOP_ACCURACY = 1
STOP_BATTERY = 2

STOP_REASONS = ("max_rounds", "accuracy_reached", "battery_low")


def stop_reason_name(code: int) -> str:
    return STOP_REASONS[int(code)]


def round_weights(n_contrib: int, strategy=None) -> np.ndarray:
    """Per-round aggregation weights over the *signed* contributors (see
    :func:`repro_torch.core.topology.contributor_round_mask`)."""
    from repro_torch.core.topology import contributor_round_mask

    if strategy is None:
        return np.ones((n_contrib,), np.float32)
    return contributor_round_mask(n_contrib, strategy)


def decayed_round_weights(weights, lag, gamma: float) -> torch.Tensor:
    """Staleness-decayed aggregation weights ``w * gamma**lag`` in fp32.

    ``weights`` (..., N), ``lag`` (..., N) int rounds-behind per
    contributor image, ``gamma`` the ``EnFedConfig.staleness_gamma`` knob;
    the one expression both engines share.

    The power is the fp32 ``gamma`` raised in fp64 and rounded to fp32,
    with results below the smallest normal fp32 flushed to zero: that is
    what XLA's ``jnp.power`` gives on the CPU (correctly rounded, denormals
    flushed) far more often than ``torch.pow`` in fp32 does."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    lag_d = torch.as_tensor(lag).to(torch.int32).to(torch.float64).to(w.device)
    base = torch.tensor(float(np.float32(gamma)), dtype=torch.float64, device=w.device)
    decay = torch.pow(base, lag_d).to(torch.float32)
    decay = torch.where(decay < torch.finfo(torch.float32).tiny, 0.0, decay)
    return w * decay
