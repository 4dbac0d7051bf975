"""Data of the port: synthetic batches and scenes with the real dataset's
schema, and the batching loader."""

from butd_detr_tpu_torch.data.loader import DataLoader, collate
from butd_detr_tpu_torch.data.synthetic import (
    SyntheticGroundingDataset,
    hilbert_code,
    synthetic_batch,
)

__all__ = ["DataLoader", "SyntheticGroundingDataset", "collate",
           "hilbert_code", "synthetic_batch"]
