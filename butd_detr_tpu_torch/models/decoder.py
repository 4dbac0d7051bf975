"""Bi-Decoder layer (reference BiDecoderLayer; JAX counterpart
butd_detr_tpu/models/decoder.py): query self-attention -> cross(language)
-> cross(detected boxes) -> cross(vision, no padding mask) -> FFN, with a
learned position embedding of the current box estimate added to every
attention's query (and key, in self-attention)."""

import torch
from torch import nn

from butd_detr_tpu_torch.models.encoder import FFN, LN_EPS
from butd_detr_tpu_torch.nn.attention import MultiheadAttention
from butd_detr_tpu_torch.nn.dropout import Dropout
from butd_detr_tpu_torch.nn.position import PositionEmbeddingLearned


class BiDecoderLayer(nn.Module):
    def __init__(self, d_model=288, n_heads=8, dim_feedforward=256,
                 dropout=0.1, self_position_embedding="loc_learned",
                 butd=False, precise=False):
        super().__init__()
        mha = lambda: MultiheadAttention(d_model, n_heads, dropout, precise)
        ln = lambda: nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_position_embedding = self_position_embedding
        self.self_attn = mha()
        self.norm1 = ln()
        self.cross_l = mha()
        self.norm_l = ln()
        self.butd = butd
        if butd:
            self.cross_d = mha()
            self.norm_d = ln()
        self.cross_v = mha()
        self.norm_v = ln()
        self.ffn = FFN(d_model, dim_feedforward, dropout)
        self.norm2 = ln()
        self.dropout = Dropout(dropout)
        if self_position_embedding == "xyz_learned":
            self.self_posembed = PositionEmbeddingLearned(3, d_model)
        elif self_position_embedding == "loc_learned":
            self.self_posembed = PositionEmbeddingLearned(6, d_model)

    def forward(self, query, vis_feats, lang_feats, query_pos, query_mask,
                text_key_padding_mask, detected_feats=None,
                detected_mask=None):
        drop = self.dropout
        if self.self_position_embedding != "none" and query_pos is not None:
            pos = self.self_posembed(query_pos)
        else:
            pos = torch.zeros_like(query)
        q2 = self.self_attn(query + pos, query + pos, query, query_mask)
        query = self.norm1(query + drop(q2))
        q2 = self.cross_l(query + pos, lang_feats, lang_feats,
                          text_key_padding_mask)
        query = self.norm_l(query + drop(q2))
        if self.butd and detected_feats is not None:
            q2 = self.cross_d(query + pos, detected_feats, detected_feats,
                              detected_mask)
            query = self.norm_d(query + drop(q2))
        q2 = self.cross_v(query + pos, vis_feats, vis_feats, None)
        query = self.norm_v(query + drop(q2))
        return self.norm2(query + self.ffn(query))
