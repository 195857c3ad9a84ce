from repro_torch.core.adversary import AdversaryConfig
from repro_torch.core.aggregation import fedavg, masked_fedavg, masked_weighted_mean_stacked
from repro_torch.core.battery import BatteryState
from repro_torch.core.cadence import CadenceConfig
from repro_torch.core.energy import CostModel, DeviceProfile, EnergyReport, LinkProfile
from repro_torch.core.faults import FaultConfig
from repro_torch.core.federated import (BaselineResult, CFLLearner, DFLLearner,
                                        FederatedTrainer, SupervisedTask,
                                        cloud_only_baseline, cloud_only_config)
from repro_torch.core.fleet import FleetResult, RequesterSpec, run_fleet
from repro_torch.core.incentive import (Contract, NeighborDevice, make_fleet,
                                        participation_mask, select_contributors,
                                        sign_contracts_fleet)
from repro_torch.core.mobility import MobilityConfig
from repro_torch.core.protocol import Phase
from repro_torch.core.rounds import EnFedConfig, EnFedSession, SessionResult
from repro_torch.core.topology import AggregationStrategy, group_mixing_matrix

# repro_torch.api facade types re-exported lazily (see __getattr__ below).
_API_EXPORTS = (
    "Experiment",
    "WorldSpec",
    "MethodSpec",
    "ExecutionSpec",
    "RunResult",
    "CompareResult",
    "register_method",
)

# The single consolidated public-API list: engine-level core names plus
# the repro_torch.api facade surface.
__all__ = [
    # aggregation + battery + cost model
    "fedavg", "masked_fedavg", "masked_weighted_mean_stacked",
    "BatteryState", "CostModel", "DeviceProfile", "EnergyReport", "LinkProfile",
    # incentives / world
    "Contract", "NeighborDevice", "make_fleet", "select_contributors",
    "participation_mask", "sign_contracts_fleet", "AdversaryConfig", "CadenceConfig",
    "FaultConfig", "MobilityConfig",
    # EnFed engines + protocol vocabulary
    "EnFedConfig", "EnFedSession", "SessionResult",
    "FleetResult", "RequesterSpec", "run_fleet", "Phase",
    # baselines
    "SupervisedTask", "BaselineResult", "CFLLearner", "DFLLearner",
    "FederatedTrainer", "cloud_only_baseline", "cloud_only_config",
    # topologies
    "AggregationStrategy", "group_mixing_matrix",
    # repro_torch.api facade (lazy)
    *_API_EXPORTS,
]


def __getattr__(name: str):
    """Lazy facade re-export: ``repro_torch.api`` imports these
    submodules, so importing it eagerly here would be a cycle; resolving
    on first access keeps both import orders working."""
    if name in _API_EXPORTS:
        import repro_torch.api as _api

        return getattr(_api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
