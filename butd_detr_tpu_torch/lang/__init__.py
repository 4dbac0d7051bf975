"""Text side of the port: RoBERTa (HF names) and the offline tokenizer."""

from butd_detr_tpu_torch.lang.roberta import (
    RobertaConfig,
    RobertaModel,
    roberta_base_config,
    tiny_roberta_config,
)
from butd_detr_tpu_torch.lang.tokenizer import SimpleTokenizer

__all__ = [
    "RobertaConfig",
    "RobertaModel",
    "SimpleTokenizer",
    "roberta_base_config",
    "tiny_roberta_config",
]
