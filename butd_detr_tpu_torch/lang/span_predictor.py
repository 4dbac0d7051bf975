"""Span predictor: a per-token binary classifier over utterances.

Counterpart of `butd_detr_tpu/lang/span_predictor.py` (reference
`src/text_cls.py:384-406`, `TextClassifier`): a trainable RoBERTa trunk
and the projector Linear(768 -> 256), ReLU, Dropout(0.1), Linear(256 -> 1),
trained with BCE against the ground-truth span map. At inference the
scores thresholded at 0 become the 256-bin span distributions that the
grounding dataset reads (`{dataset}_pred_spans.json`).

In train mode the trunk drops as the JAX tower does (the attention
probabilities inside the attention kernels) and the projector drops after
its ReLU; every mask comes from the predictor's one `DropoutRng`, `rng`.
"""

import numpy as np
import torch
from torch import nn

from butd_detr_tpu_torch.lang.roberta import RobertaConfig, RobertaModel
from butd_detr_tpu_torch.nn.dropout import (
    Dropout,
    DropoutRng,
    bind_rng,
    dropout,
)
from butd_detr_tpu_torch.nn.mlp import Dense


class SpanPredictor(nn.Module):
    """input_ids (B, L), attention_mask (B, L) -> span logits (B, L).
    `precise` is the attention mode of the trunk (f32 throughout), `dtype`
    the compute dtype of its dense layers and the projector's."""

    def __init__(self, config: RobertaConfig, precise: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.text_encoder = RobertaModel(config, precise=precise,
                                         dtype=dtype)
        self.projector = nn.Sequential(
            Dense(config.hidden_size, 256, dtype=dtype), nn.ReLU(),
            Dropout(0.1),  # applied by `train`, not by the module's mode
            Dense(256, 1, dtype=dtype))
        self.rng = bind_rng(self, DropoutRng())

    def forward(self, input_ids, attention_mask, train: bool = False):
        x = self.text_encoder(input_ids, attention_mask, train)
        proj = self.projector
        x = proj[1](proj[0](x))
        if train:
            x = dropout(x, proj[2].p, self.rng)
        return proj[3](x)[..., 0]


def span_bce_loss(logits: torch.Tensor, positive_map: torch.Tensor,
                  attention_mask=None) -> torch.Tensor:
    """BCE with logits against the span map (text_cls.py:93-96), in f32:
    the mean over the full (B, L) grid, padding included, as the
    reference; with `attention_mask`, over the real tokens."""
    z = logits.float()
    t = positive_map.float()
    per = torch.clamp(z, min=0) - z * t + torch.log1p(torch.exp(-z.abs()))
    if attention_mask is None:
        return per.mean()
    w = attention_mask.float()
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def scores_to_pred_spans(scores: np.ndarray) -> np.ndarray:
    """(B, L) scores -> (B, 256) L1-normalized span distributions: the
    scores binarized at 0; a row with no positive bin takes a one-hot at
    its argmax (text_cls.py:111-121)."""
    B, L = scores.shape
    pad = np.zeros((B, 256), np.float32)
    pad[:, :L] = (scores > 0).astype(np.float32)
    empty = pad.sum(1) < 1
    if empty.any():
        am = scores[empty].argmax(1)
        pad[np.flatnonzero(empty), am] = 1.0
    return pad / pad.sum(1, keepdims=True)
