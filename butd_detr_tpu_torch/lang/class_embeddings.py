"""Class-name RoBERTa embeddings for the detected-box ("butd") stream.

Counterpart of `butd_detr_tpu/lang/class_embeddings.py` (reference
`data/gen_class_embeddings.py:8-25`): each of the 485 ScanNet class names
goes through RoBERTa, and its token states are averaged under the
attention mask. The (num_classes, hidden) table initializes the model's
`butd_class_embeddings` (`train/pretrained.py:init_class_embeddings`
loads it from the `.npy` file).
"""

from typing import List

import numpy as np
import torch
from torch import nn

from butd_detr_tpu_torch.train.pretrained import init_text_encoder


@torch.no_grad()
def generate_class_embeddings(model, tokenizer, class_names: List[str],
                              max_len: int = 16,
                              batch_size: int = 64) -> np.ndarray:
    """(num_classes, hidden) float32: RoBERTa's (`model`, on its device,
    eval mode) token states summed under the attention mask and divided
    by the token count, `batch_size` names a forward
    (gen_class_embeddings.py:17-25)."""
    device = next(model.parameters()).device
    out = []
    for i in range(0, len(class_names), batch_size):
        tok = tokenizer(class_names[i:i + batch_size], max_len=max_len)
        ids = torch.from_numpy(tok.ids).long().to(device)
        mask = torch.from_numpy(tok.attention_mask).to(device)
        hidden = model(ids, mask, train=False)
        w = mask[..., None].to(hidden.dtype)
        out.append(((hidden * w).sum(1)
                    / torch.clamp(w.sum(1), min=1.0)).cpu().numpy())
    return np.concatenate(out, axis=0)


def load_roberta_weights(model, source=None) -> None:
    """RoBERTa weights (HF names; `train/pretrained.py:roberta_state_dict`:
    None is the local HF cache, else a directory or a weights file) into
    the bare `RobertaModel` `model`, in place."""
    holder = nn.Module()
    holder.text_encoder = model
    init_text_encoder(holder, source)
