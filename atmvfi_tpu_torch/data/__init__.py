"""Datasets and the host-side input pipeline (the port's
`atmvfi_tpu/data/`)."""

from atmvfi_tpu_torch.data.datasets import (
    SNUFilmDataset,
    VimeoDataset,
    X4KTest,
    X4KTrain,
)
from atmvfi_tpu_torch.data.loader import DataLoader

__all__ = [
    "DataLoader",
    "SNUFilmDataset",
    "VimeoDataset",
    "X4KTest",
    "X4KTrain",
]
