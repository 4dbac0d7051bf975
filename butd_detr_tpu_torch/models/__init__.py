"""The grounding model of the port."""

from butd_detr_tpu_torch.models.bdetr import (
    BeaUTyDETR,
    prediction_prefixes,
    top_k_stable,
)

__all__ = ["BeaUTyDETR", "prediction_prefixes", "top_k_stable"]
