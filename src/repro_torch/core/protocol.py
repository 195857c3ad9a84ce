"""EnFed protocol vocabulary (the part of ``repro.core.protocol`` the loop
engine uses): stop reasons and per-round aggregation weights."""

from __future__ import annotations

import numpy as np


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
