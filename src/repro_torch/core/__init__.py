from repro_torch.core.battery import BatteryState
from repro_torch.core.energy import CostModel, DeviceProfile, EnergyReport, LinkProfile
from repro_torch.core.federated import SupervisedTask
from repro_torch.core.incentive import Contract, NeighborDevice, make_fleet, select_contributors
from repro_torch.core.rounds import EnFedConfig, EnFedSession, SessionResult
from repro_torch.core.topology import AggregationStrategy

__all__ = [
    "AggregationStrategy",
    "BatteryState",
    "Contract",
    "CostModel",
    "DeviceProfile",
    "EnFedConfig",
    "EnFedSession",
    "EnergyReport",
    "LinkProfile",
    "NeighborDevice",
    "SessionResult",
    "SupervisedTask",
    "make_fleet",
    "select_contributors",
]
