from repro_torch.data.har import (
    CaloriesDatasetConfig,
    HARDatasetConfig,
    make_calories_tabular,
    make_har_windows,
)
from repro_torch.data.loader import batch_iterator, train_test_split
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.tokens import synthetic_token_batches

__all__ = [
    "make_har_windows",
    "make_calories_tabular",
    "HARDatasetConfig",
    "CaloriesDatasetConfig",
    "dirichlet_partition",
    "iid_partition",
    "batch_iterator",
    "train_test_split",
    "synthetic_token_batches",
]
