"""Battery state and discharge model (copy of ``repro.core.battery``).

The paper gates EnFed rounds on the requesting device's battery:
continue only while ``B_p >= B_min_A`` (Algorithm 1, checkbatterylevel).
Discharge is non-linear in reality (paper §III notes this); we model the
energy-to-charge conversion with a load-dependent efficiency factor so
heavy phases (training) drain proportionally more than their Joule count.

:class:`BatteryState` is the host-side state of one requesting device
(``repro_torch.core.rounds``); :func:`discharge_level` is its formula, on
floats there and on the fleet's per-lane fp32 tensors.
"""

from __future__ import annotations

import dataclasses

import torch


def load_efficiency(avg_power_w: float, high_load_penalty: float,
                    high_load_threshold_w: float) -> float:
    """Peukert-like efficiency factor: >1 under heavy draw."""
    return 1.0 + (high_load_penalty if avg_power_w > high_load_threshold_w else 0.0)


def discharge_level(level, energy_j, capacity_j, efficiency=1.0):
    """New battery fraction after spending ``energy_j`` joules; floats
    (the loop engine) or tensors of per-lane levels (the fleet)."""
    new_level = level - efficiency * energy_j / capacity_j
    if isinstance(new_level, torch.Tensor):
        return torch.clamp_min(new_level, 0.0)
    return max(new_level, 0.0)


@dataclasses.dataclass
class BatteryState:
    capacity_j: float = 40e3
    level: float = 1.0                 # fraction of capacity remaining
    # non-linearity: effective capacity shrinks under high draw (Peukert-like)
    high_load_penalty: float = 0.15
    high_load_threshold_w: float = 3.0

    def discharge(self, energy_j: float, avg_power_w: float = 1.0) -> "BatteryState":
        eff = load_efficiency(avg_power_w, self.high_load_penalty,
                              self.high_load_threshold_w)
        new_level = discharge_level(self.level, energy_j, self.capacity_j, eff)
        return dataclasses.replace(self, level=float(new_level))

    def below(self, threshold: float) -> bool:
        return self.level < threshold

    @property
    def percent(self) -> float:
        return 100.0 * self.level
