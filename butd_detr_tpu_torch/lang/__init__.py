"""Text side of the port: RoBERTa (HF names) and the tokenizers.

The RoBERTa names import torch on first use only, so that the data
pipeline's worker processes, which unpickle a tokenizer, import no torch.
"""

from butd_detr_tpu_torch.lang.tokenizer import (
    HFTokenizer,
    SimpleTokenizer,
    get_tokenizer,
)

_ROBERTA = ("RobertaConfig", "RobertaModel", "roberta_base_config",
            "tiny_roberta_config")


def __getattr__(name):
    if name in _ROBERTA:
        from butd_detr_tpu_torch.lang import roberta

        return getattr(roberta, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "HFTokenizer",
    "SimpleTokenizer",
    "get_tokenizer",
    *_ROBERTA,
]
