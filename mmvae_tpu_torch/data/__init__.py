from .loaders import (  # noqa: F401
    DATASETS, ArrayLoader, PairedDataset, get_dataloaders, torch_split_indices,
)
