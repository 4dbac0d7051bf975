"""Cross-modal Bi-Encoder (reference models/encoder_decoder_layers.py;
JAX counterpart butd_detr_tpu/models/encoder.py): per layer, visual and
language self-attention (+ residual + LN, no FFN), then language <- vision
cross-attention + FFN, vision <- (pre-update) language, vision <- detected
boxes, and the vision FFN. Batch-first (B, L, F); masks True == PAD.
Dropout (0.1 on every residual branch, inside the FFNs and on the attention
probabilities) is live in train mode and identity in eval."""

from torch import nn

from butd_detr_tpu_torch.nn.attention import MultiheadAttention
from butd_detr_tpu_torch.nn.dropout import Dropout

LN_EPS = 1e-5


class FFN(nn.Sequential):
    """Linear-ReLU-Dropout-Linear-Dropout (keys 0 and 3)."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 dropout: float = 0.1):
        super().__init__(
            nn.Linear(d_model, dim_feedforward), nn.ReLU(),
            Dropout(dropout), nn.Linear(dim_feedforward, d_model),
            Dropout(dropout))


class SelfAttnNoFFN(nn.Module):
    """Self-attention + residual + LN; optional position added to q, k."""

    def __init__(self, d_model, n_heads, dropout=0.1, precise=False):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads, dropout,
                                            precise)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = Dropout(dropout)

    def forward(self, x, pos=None, key_padding_mask=None):
        qk = x if pos is None else x + pos
        a = self.self_attn(qk, qk, x, key_padding_mask)
        return self.norm1(x + self.dropout(a))


class CrossAttentionLayer(nn.Module):
    def __init__(self, d_model=288, n_heads=8, dim_feedforward=256,
                 dropout=0.1, use_butd_enc_attn=False, precise=False):
        super().__init__()
        mha = lambda: MultiheadAttention(d_model, n_heads, dropout, precise)
        ln = lambda: nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_lv = mha()
        self.norm_lv = ln()
        self.ffn_lv = FFN(d_model, dim_feedforward, dropout)
        self.norm_lv2 = ln()
        self.cross_vl = mha()
        self.norm_vl = ln()
        self.use_butd_enc_attn = use_butd_enc_attn
        if use_butd_enc_attn:
            self.cross_d = mha()
            self.norm_d = ln()
        self.ffn_vl = FFN(d_model, dim_feedforward, dropout)
        self.norm_vl2 = ln()
        self.dropout = Dropout(dropout)

    def forward(self, vis_feats, vis_key_padding_mask, text_feats,
                text_key_padding_mask, pos_feats, detected_feats=None,
                detected_mask=None):
        drop = self.dropout
        qv = vis_feats + pos_feats  # pos only on the vision query
        # vision attends to the ORIGINAL text (the reference binds k/v
        # before the language update)
        kt = vt = text_feats
        t2 = self.cross_lv(text_feats, vis_feats, vis_feats,
                           vis_key_padding_mask)
        text_feats = self.norm_lv(text_feats + drop(t2))
        text_feats = self.norm_lv2(text_feats + self.ffn_lv(text_feats))

        v2 = self.cross_vl(qv, kt, vt, text_key_padding_mask)
        vis_feats = self.norm_vl(vis_feats + drop(v2))
        if detected_feats is not None and self.use_butd_enc_attn:
            v2 = self.cross_d(vis_feats, detected_feats, detected_feats,
                              detected_mask)
            vis_feats = self.norm_d(vis_feats + drop(v2))
        vis_feats = self.norm_vl2(vis_feats + self.ffn_vl(vis_feats))
        return vis_feats, text_feats


class BiEncoderLayer(nn.Module):
    def __init__(self, d_model=288, n_heads=8, dim_feedforward=256,
                 dropout=0.1, self_attend_lang=True, self_attend_vis=True,
                 use_butd_enc_attn=False, precise=False):
        super().__init__()
        if self_attend_vis:
            self.self_attention_visual = SelfAttnNoFFN(
                d_model, n_heads, dropout, precise)
        if self_attend_lang:
            self.self_attention_lang = SelfAttnNoFFN(
                d_model, n_heads, dropout, precise)
        self.self_attend_vis = self_attend_vis
        self.self_attend_lang = self_attend_lang
        self.cross_layer = CrossAttentionLayer(
            d_model, n_heads, dim_feedforward, dropout, use_butd_enc_attn,
            precise)

    def forward(self, vis_feats, pos_feats, padding_mask, text_feats,
                text_padding_mask, detected_feats=None, detected_mask=None):
        if self.self_attend_vis:
            vis_feats = self.self_attention_visual(
                vis_feats, pos_feats, padding_mask)
        if self.self_attend_lang:
            text_feats = self.self_attention_lang(
                text_feats, None, text_padding_mask)
        return self.cross_layer(vis_feats, padding_mask, text_feats,
                                text_padding_mask, pos_feats,
                                detected_feats, detected_mask)


class BiEncoder(nn.Module):
    def __init__(self, num_layers=3, d_model=288, n_heads=8,
                 dim_feedforward=256, dropout=0.1, self_attend=True,
                 use_butd_enc_attn=False, precise=False):
        super().__init__()
        self.layers = nn.ModuleList(
            BiEncoderLayer(d_model, n_heads, dim_feedforward, dropout,
                           self_attend, self_attend, use_butd_enc_attn,
                           precise)
            for _ in range(num_layers))

    def forward(self, vis_feats, pos_feats, padding_mask, text_feats,
                text_padding_mask, detected_feats=None, detected_mask=None):
        for layer in self.layers:
            vis_feats, text_feats = layer(
                vis_feats, pos_feats, padding_mask, text_feats,
                text_padding_mask, detected_feats, detected_mask)
        return vis_feats, text_feats
