from repro_torch.data.har import (
    CaloriesDatasetConfig,
    HARDatasetConfig,
    make_calories_tabular,
    make_har_windows,
)
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.tokens import synthetic_token_batches

__all__ = [
    "make_har_windows",
    "make_calories_tabular",
    "HARDatasetConfig",
    "CaloriesDatasetConfig",
    "dirichlet_partition",
    "synthetic_token_batches",
]
