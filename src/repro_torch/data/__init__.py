from repro_torch.data.har import (
    CaloriesDatasetConfig,
    HARDatasetConfig,
    make_calories_tabular,
    make_har_windows,
)
from repro_torch.data.partition import dirichlet_partition

__all__ = [
    "make_har_windows",
    "make_calories_tabular",
    "HARDatasetConfig",
    "CaloriesDatasetConfig",
    "dirichlet_partition",
]
