from repro_torch.core.adversary import AdversaryConfig
from repro_torch.core.battery import BatteryState
from repro_torch.core.energy import CostModel, DeviceProfile, EnergyReport, LinkProfile
from repro_torch.core.federated import SupervisedTask
from repro_torch.core.fleet import FleetResult, RequesterSpec, run_fleet
from repro_torch.core.incentive import (Contract, NeighborDevice, make_fleet,
                                        select_contributors, sign_contracts_fleet)
from repro_torch.core.rounds import EnFedConfig, EnFedSession, SessionResult
from repro_torch.core.topology import AggregationStrategy

__all__ = [
    "AdversaryConfig",
    "AggregationStrategy",
    "BatteryState",
    "Contract",
    "CostModel",
    "DeviceProfile",
    "EnFedConfig",
    "EnFedSession",
    "EnergyReport",
    "FleetResult",
    "LinkProfile",
    "NeighborDevice",
    "RequesterSpec",
    "SessionResult",
    "SupervisedTask",
    "make_fleet",
    "run_fleet",
    "select_contributors",
    "sign_contracts_fleet",
]
