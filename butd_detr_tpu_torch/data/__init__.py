"""Data of the port: synthetic batches with the real dataset's schema."""

from butd_detr_tpu_torch.data.synthetic import hilbert_code, synthetic_batch

__all__ = ["hilbert_code", "synthetic_batch"]
