"""BUTD-DETR in plain PyTorch and float32: the benchmark's reference model.

A frozen copy of the plain path of `butd_detr_tpu_torch` (models/, nn/,
lang/roberta.py), importing nothing of the program: the same modules under
the same parameter names (a state dict loads into both), every dense layer,
attention and MLP in float32 (the program computes the PointNet++ MLPs and
the attention operands in bf16), gathers through `torch.gather`, gradients
from autograd. Dropout draws what the program draws: the elementwise masks
from one `torch.Generator` on the input's device seeded by the step's seed,
in the same order and shapes, and each attention call's Philox seed from
the same counter, so that a training step drops the same entries on both
sides. The query selection can be handed the program's indices
(`decode(..., sample_inds)`) so that the continuous outputs are compared on
the same queries; the selection itself is judged apart.
"""

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops

_SEED_MASK = 2 ** 63 - 1
_CALL_STRIDE = 0x9E3779B97F4A7C15
LN_EPS = 1e-5


# ------------------------------------------------------------------ dropout

class DropoutRng:
    def __init__(self, seed: int = 0):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self._seed = int(seed) & _SEED_MASK
        self._generators = {}
        self._calls = 0

    def generator(self, device) -> torch.Generator:
        device = torch.device(device)
        if device not in self._generators:
            g = torch.Generator(device=device)
            g.manual_seed(self._seed)
            self._generators[device] = g
        return self._generators[device]

    def next_seed(self) -> int:
        self._calls += 1
        return (self._seed * _CALL_STRIDE + self._calls) % 2 ** 64


def dropout(x, p, rng):
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, device=x.device, dtype=torch.float32,
                      generator=rng.generator(x.device)) >= p
    return x * (keep.float() / (1.0 - p))


class Dropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.rng = DropoutRng()

    def forward(self, x):
        return dropout(x, self.p, self.rng) if self.training else x


def bind_rng(model: nn.Module, rng: DropoutRng) -> DropoutRng:
    for m in model.modules():
        if isinstance(getattr(m, "rng", None), DropoutRng):
            m.rng = rng
    return rng


# --------------------------------------------------------------- layers

class Dense(nn.Linear):
    pass


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return super().forward(x.float())


class PointwiseConv(nn.Module):
    def __init__(self, cin, cout, bias=True, kernel_dims=1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin,
                                               *([1] * kernel_dims)))
        if bias:
            self.bias = nn.Parameter(torch.empty(cout))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return F.linear(x.float(), self.weight.flatten(1), self.bias)


class BatchNorm(nn.BatchNorm1d):
    """Over the last axis: batch statistics (biased variance) in train
    mode, the running ones in eval. With a process `group` the train-mode
    statistics are the group's: the mean, then the mean squared deviation
    from it, each from sums over every rank's rows."""

    def __init__(self, num_features):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.group = None

    def _over_ranks(self, xf):
        C = xf.shape[-1]
        sums = ops.sum_over_ranks(
            torch.cat([xf.sum(dim=0), xf.new_full((1,), xf.shape[0])]),
            self.group)
        mean = sums[:C] / sums[C]
        d = xf - mean
        var = ops.sum_over_ranks((d * d).sum(dim=0), self.group) / sums[C]
        return d * torch.rsqrt(var + self.eps) * self.weight + self.bias

    def forward(self, x):
        xf = x.reshape(-1, x.shape[-1]).float()
        if self.training and self.group is not None:
            y = self._over_ranks(xf)
        elif self.training:
            y = F.batch_norm(xf, None, None, self.weight, self.bias, True,
                             0.0, self.eps)
        else:
            y = F.batch_norm(xf, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
        return y.reshape(x.shape)


class _BNWrap(nn.Module):
    def __init__(self, n):
        super().__init__()
        self.bn = BatchNorm(n)

    def forward(self, x):
        return self.bn(x)


class _ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, kernel_dims):
        super().__init__()
        self.conv = PointwiseConv(cin, cout, bias=False,
                                  kernel_dims=kernel_dims)
        self.bn = _BNWrap(cout)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class SharedMLP(nn.Module):
    def __init__(self, channels):
        super().__init__()
        for i, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
            self.add_module(f"layer{i}", _ConvBNReLU(cin, cout, 2))

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x


class PositionEmbeddingLearned(nn.Module):
    def __init__(self, cin, f=288):
        super().__init__()
        self.position_embedding_head = nn.Sequential(
            PointwiseConv(cin, f), BatchNorm(f), nn.ReLU(),
            PointwiseConv(f, f))

    def forward(self, xyz):
        return self.position_embedding_head(xyz)


def multi_head(q, k, v, num_heads, key_padding_mask, dropout_p, seed):
    B, Lq, D = q.shape
    Lk = k.shape[1]
    Dh = D // num_heads
    out = ops.attention(
        q.view(B, Lq, num_heads, Dh).transpose(1, 2),
        k.view(B, Lk, num_heads, Dh).transpose(1, 2),
        v.view(B, Lk, num_heads, Dh).transpose(1, 2),
        key_padding_mask, sm_scale=1.0 / (float(Dh) ** 0.5),
        dropout_p=dropout_p, seed=seed)
    return out.transpose(1, 2).reshape(B, Lq, D)


class MultiheadAttention(nn.Module):
    def __init__(self, d_model, num_heads, dropout=0.0):
        super().__init__()
        self.d_model, self.num_heads, self.dropout = d_model, num_heads, \
            dropout
        self.rng = DropoutRng()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = Dense(d_model, d_model)

    def forward(self, query, key, value, key_padding_mask=None):
        d = self.d_model
        w, b = self.in_proj_weight, self.in_proj_bias
        q = F.linear(query, w[:d], b[:d])
        k = F.linear(key, w[d:2 * d], b[d:2 * d])
        v = F.linear(value, w[2 * d:], b[2 * d:])
        p = self.dropout if self.training else 0.0
        out = multi_head(q, k, v, self.num_heads, key_padding_mask, p,
                         self.rng.next_seed() if p > 0.0 else None)
        return self.out_proj(out)


# ------------------------------------------------------------ PointNet++

class QueryAndGroup(nn.Module):
    def __init__(self, radius, nsample):
        super().__init__()
        self.radius, self.nsample = radius, nsample
        # the f32 reciprocal of the radius, as the program multiplies by
        self.inv_r = float(np.float32(1.0) / np.float32(radius))

    def forward(self, xyz, new_xyz, features):
        idx = ops.ball_query(self.radius, self.nsample, xyz, new_xyz)
        grouped = ops.gather_points(torch.cat([xyz, features], dim=-1), idx)
        gx = (grouped[..., :3] - new_xyz[:, :, None, :]) * self.inv_r
        return torch.cat([gx, grouped[..., 3:]], dim=-1)


class PointnetSAModuleVotes(nn.Module):
    def __init__(self, npoint, radius, nsample, in_channels, mlp):
        super().__init__()
        self.npoint = npoint
        self.grouper = QueryAndGroup(radius, nsample)
        self.mlp_module = SharedMLP([in_channels + 3, *mlp])

    def forward(self, xyz, features):
        inds = ops.furthest_point_sample(xyz, self.npoint)
        new_xyz = ops.gather_points(xyz, inds)
        grouped = self.grouper(xyz, new_xyz, features)
        return new_xyz, self.mlp_module(grouped).amax(dim=2), inds


class PointnetFPModule(nn.Module):
    def __init__(self, mlp):
        super().__init__()
        self.mlp = SharedMLP(mlp)

    def forward(self, unknown, known, unknown_feats, known_feats):
        dist, idx = ops.three_nn(unknown, known)
        recip = 1.0 / (dist + 1e-8)
        weight = recip / recip.sum(dim=-1, keepdim=True)
        interp = ops.three_interpolate(known_feats, idx, weight)
        return self.mlp(torch.cat([interp, unknown_feats], dim=-1))


class Pointnet2Backbone(nn.Module):
    def __init__(self, input_feature_dim, output_dim, npoints,
                 radii=(0.2, 0.4, 0.8, 1.2), nsamples=(64, 32, 16, 16)):
        super().__init__()
        self.sa1 = PointnetSAModuleVotes(npoints[0], radii[0], nsamples[0],
                                         input_feature_dim, [64, 64, 128])
        self.sa2 = PointnetSAModuleVotes(npoints[1], radii[1], nsamples[1],
                                         128, [128, 128, 256])
        self.sa3 = PointnetSAModuleVotes(npoints[2], radii[2], nsamples[2],
                                         256, [128, 128, 256])
        self.sa4 = PointnetSAModuleVotes(npoints[3], radii[3], nsamples[3],
                                         256, [128, 128, 256])
        self.fp1 = PointnetFPModule([512, 256, 256])
        self.fp2 = PointnetFPModule([512, 256, output_dim])

    def forward(self, pc):
        xyz = pc[..., :3].float()
        feats = pc[..., 3:].float()
        xyz1, f1, inds1 = self.sa1(xyz, feats)
        xyz2, f2, inds2 = self.sa2(xyz1, f1)
        xyz3, f3, _ = self.sa3(xyz2, f2)
        xyz4, f4, _ = self.sa4(xyz3, f3)
        f3up = self.fp1(xyz3, xyz4, f3, f4)
        return {"sa1_inds": inds1, "sa2_inds": inds2,
                "fp2_features": self.fp2(xyz2, xyz3, f2, f3up),
                "fp2_xyz": xyz2, "fp2_inds": inds1[:, :xyz2.shape[1]]}


# --------------------------------------------------------------- RoBERTa

class _Dense(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.dense = Dense(cin, cout)


class _DenseLN(nn.Module):
    def __init__(self, cin, cout, eps):
        super().__init__()
        self.dense = Dense(cin, cout)
        self.LayerNorm = LayerNorm(cout, eps=eps)


class RobertaEmbeddings(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.pad = c["pad_token_id"]
        h = c["hidden_size"]
        self.word_embeddings = nn.Embedding(c["vocab_size"], h)
        self.position_embeddings = nn.Embedding(
            c["max_position_embeddings"], h)
        self.token_type_embeddings = nn.Embedding(c["type_vocab_size"], h)
        self.LayerNorm = LayerNorm(h, eps=c["layer_norm_eps"])

    def forward(self, ids):
        mask = (ids != self.pad).long()
        pos = torch.cumsum(mask, dim=1) * mask + self.pad
        x = (self.word_embeddings(ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(torch.zeros_like(ids)))
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, h):
        super().__init__()
        self.query, self.key, self.value = Dense(h, h), Dense(h, h), \
            Dense(h, h)


class _Attention(nn.Module):
    def __init__(self, c):
        super().__init__()
        h = c["hidden_size"]
        self.self = _SelfAttention(h)
        self.output = _DenseLN(h, h, c["layer_norm_eps"])


class RobertaLayer(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.heads = c["num_attention_heads"]
        self.attention = _Attention(c)
        self.intermediate = _Dense(c["hidden_size"], c["intermediate_size"])
        self.output = _DenseLN(c["intermediate_size"], c["hidden_size"],
                               c["layer_norm_eps"])

    def forward(self, x, pad_mask):
        sa = self.attention.self
        a = multi_head(sa.query(x), sa.key(x), sa.value(x), self.heads,
                       pad_mask, 0.0, None)
        x = self.attention.output.LayerNorm(x + self.attention.output.dense(a))
        h = self.output.dense(F.gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + h)


class _Encoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.layer = nn.ModuleList(RobertaLayer(c)
                                   for _ in range(c["num_hidden_layers"]))


class RobertaModel(nn.Module):
    """The frozen text tower, run as the program runs it: eval mode."""

    def __init__(self, c):
        super().__init__()
        self.embeddings = RobertaEmbeddings(c)
        self.encoder = _Encoder(c)

    def forward(self, ids, attention_mask):
        pad_mask = attention_mask == 0
        x = self.embeddings(ids.long())
        for layer in self.encoder.layer:
            x = layer(x, pad_mask)
        return x


# ------------------------------------------------------------ transformer

class FFN(nn.Sequential):
    def __init__(self, d, ff, p):
        super().__init__(Dense(d, ff), nn.ReLU(), Dropout(p), Dense(ff, d),
                         Dropout(p))


class SelfAttnNoFFN(nn.Module):
    def __init__(self, d, h, p):
        super().__init__()
        self.self_attn = MultiheadAttention(d, h, p)
        self.norm1 = LayerNorm(d, eps=LN_EPS)
        self.dropout = Dropout(p)

    def forward(self, x, pos=None, key_padding_mask=None):
        qk = x if pos is None else x + pos
        return self.norm1(x + self.dropout(
            self.self_attn(qk, qk, x, key_padding_mask)))


class CrossAttentionLayer(nn.Module):
    def __init__(self, d, h, ff, p, butd):
        super().__init__()
        self.cross_lv = MultiheadAttention(d, h, p)
        self.norm_lv = LayerNorm(d, eps=LN_EPS)
        self.ffn_lv = FFN(d, ff, p)
        self.norm_lv2 = LayerNorm(d, eps=LN_EPS)
        self.cross_vl = MultiheadAttention(d, h, p)
        self.norm_vl = LayerNorm(d, eps=LN_EPS)
        self.butd = butd
        if butd:
            self.cross_d = MultiheadAttention(d, h, p)
            self.norm_d = LayerNorm(d, eps=LN_EPS)
        self.ffn_vl = FFN(d, ff, p)
        self.norm_vl2 = LayerNorm(d, eps=LN_EPS)
        self.dropout = Dropout(p)

    def forward(self, vis, vis_pad, text, text_pad, pos, det, det_mask):
        drop = self.dropout
        qv = vis + pos
        kt = vt = text
        t2 = self.cross_lv(text, vis, vis, vis_pad)
        text = self.norm_lv(text + drop(t2))
        text = self.norm_lv2(text + self.ffn_lv(text))
        v2 = self.cross_vl(qv, kt, vt, text_pad)
        vis = self.norm_vl(vis + drop(v2))
        if det is not None and self.butd:
            vis = self.norm_d(vis + drop(self.cross_d(vis, det, det,
                                                      det_mask)))
        vis = self.norm_vl2(vis + self.ffn_vl(vis))
        return vis, text


class BiEncoderLayer(nn.Module):
    def __init__(self, d, h, ff, p, butd):
        super().__init__()
        self.self_attention_visual = SelfAttnNoFFN(d, h, p)
        self.self_attention_lang = SelfAttnNoFFN(d, h, p)
        self.cross_layer = CrossAttentionLayer(d, h, ff, p, butd)

    def forward(self, vis, pos, pad, text, text_pad, det, det_mask):
        vis = self.self_attention_visual(vis, pos, pad)
        text = self.self_attention_lang(text, None, text_pad)
        return self.cross_layer(vis, pad, text, text_pad, pos, det, det_mask)


class BiEncoder(nn.Module):
    def __init__(self, n, d, h, ff, p, butd):
        super().__init__()
        self.layers = nn.ModuleList(BiEncoderLayer(d, h, ff, p, butd)
                                    for _ in range(n))

    def forward(self, vis, pos, pad, text, text_pad, det, det_mask):
        for layer in self.layers:
            vis, text = layer(vis, pos, pad, text, text_pad, det, det_mask)
        return vis, text


class BiDecoderLayer(nn.Module):
    def __init__(self, d, h, ff, p, butd):
        super().__init__()
        self.self_attn = MultiheadAttention(d, h, p)
        self.norm1 = LayerNorm(d, eps=LN_EPS)
        self.cross_l = MultiheadAttention(d, h, p)
        self.norm_l = LayerNorm(d, eps=LN_EPS)
        self.butd = butd
        if butd:
            self.cross_d = MultiheadAttention(d, h, p)
            self.norm_d = LayerNorm(d, eps=LN_EPS)
        self.cross_v = MultiheadAttention(d, h, p)
        self.norm_v = LayerNorm(d, eps=LN_EPS)
        self.ffn = FFN(d, ff, p)
        self.norm2 = LayerNorm(d, eps=LN_EPS)
        self.dropout = Dropout(p)
        self.self_posembed = PositionEmbeddingLearned(6, d)

    def forward(self, query, vis, lang, query_pos, lang_pad, det, det_mask):
        drop = self.dropout
        pos = self.self_posembed(query_pos)
        query = self.norm1(query + drop(self.self_attn(
            query + pos, query + pos, query, None)))
        query = self.norm_l(query + drop(self.cross_l(
            query + pos, lang, lang, lang_pad)))
        if self.butd and det is not None:
            query = self.norm_d(query + drop(self.cross_d(
                query + pos, det, det, det_mask)))
        query = self.norm_v(query + drop(self.cross_v(
            query + pos, vis, vis, None)))
        return self.norm2(query + self.ffn(query))


class ThreeLayerMLP(nn.Module):
    def __init__(self, dim, out_dim):
        super().__init__()
        self.net = nn.Sequential(
            PointwiseConv(dim, dim, bias=False), BatchNorm(dim), nn.ReLU(),
            Dropout(0.3), PointwiseConv(dim, dim, bias=False),
            BatchNorm(dim), nn.ReLU(), Dropout(0.3),
            PointwiseConv(dim, out_dim))

    def forward(self, x):
        return self.net(x)


class ClsAgnosticPredictHead(nn.Module):
    def __init__(self, num_class, d):
        super().__init__()
        self.center_residual_head = ThreeLayerMLP(d, 3)
        self.size_pred_head = ThreeLayerMLP(d, 3)
        self.sem_cls_scores_head = ThreeLayerMLP(d, num_class)

    def forward(self, feats, base_xyz):
        return {"center": base_xyz + self.center_residual_head(feats),
                "pred_size": self.size_pred_head(feats),
                "sem_cls_scores": self.sem_cls_scores_head(feats)}


class PointsObjClsModule(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.conv1 = PointwiseConv(d, d)
        self.bn1 = BatchNorm(d)
        self.conv2 = PointwiseConv(d, d)
        self.bn2 = BatchNorm(d)
        self.conv3 = PointwiseConv(d, 1)

    def forward(self, x):
        x = self.bn1(self.conv1(x)).relu()
        x = self.bn2(self.conv2(x)).relu()
        return self.conv3(x)[..., 0]


def contrastive_projection(d, out=64):
    return nn.Sequential(Dense(d, d), nn.ReLU(), Dense(d, d), nn.ReLU(),
                         Dense(d, out))


def l2_normalize(x, eps=1e-12):
    return x / torch.clamp_min(x.square().sum(-1, keepdim=True).sqrt(), eps)


def prediction_prefixes(num_decoder_layers: int):
    return (["proposal_"]
            + [f"{i}head_" for i in range(num_decoder_layers - 1)]
            + ["last_"])


def top_k_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]


class BeaUTyDETR(nn.Module):
    """`model` holds the widths of the configuration file's `model` group;
    `roberta` its `text_encoder` group."""

    def __init__(self, model: Dict, roberta: Dict):
        super().__init__()
        d, h, ff, p = (model["d_model"], model["num_heads"],
                       model["dim_feedforward"], model["dropout"])
        self.num_queries = model["num_queries"]
        self.num_decoder_layers = model["num_decoder_layers"]
        self.butd = model["butd"]
        self.backbone_net = Pointnet2Backbone(
            model["input_feature_dim"], d, model["backbone_npoints"],
            model["backbone_radii"], model["backbone_nsamples"])
        self.text_encoder = RobertaModel(roberta)
        self.text_encoder.requires_grad_(False)
        self.text_projector = nn.Sequential(
            Dense(roberta["hidden_size"], d), LayerNorm(d, eps=1e-12),
            Dropout(0.1))
        if self.butd:
            self.butd_class_embeddings = nn.Embedding(
                model["num_obj_class"], model["text_hidden"])
            self.box_embeddings = PositionEmbeddingLearned(
                6, model["box_emb_dim"])
            self.class_embeddings = Dense(model["text_hidden"],
                                          d - model["box_emb_dim"])
        self.pos_embed = PositionEmbeddingLearned(3, d)
        self.cross_encoder = BiEncoder(model["num_encoder_layers"], d, h, ff,
                                       p, self.butd)
        self.contrastive_align_projection_image = contrastive_projection(d)
        self.contrastive_align_projection_text = contrastive_projection(d)
        self.points_obj_cls = PointsObjClsModule(d)
        self.decoder_query_proj = PointwiseConv(d, d)
        self.proposal_head = ClsAgnosticPredictHead(model["num_class"], d)
        self.decoder = nn.ModuleList(
            BiDecoderLayer(d, h, ff, p, self.butd)
            for _ in range(self.num_decoder_layers))
        self.prediction_heads = nn.ModuleList(
            ClsAgnosticPredictHead(model["num_class"], d)
            for _ in range(self.num_decoder_layers))
        self.rng = bind_rng(self, DropoutRng())

    def encode(self, inputs, backbone=None):
        """`backbone`: the backbone's end points to take instead of
        computing them (the program's own, to compare the stages after
        the backbone alone)."""
        ep = dict(backbone if backbone is not None
                  else self.backbone_net(inputs["point_clouds"]))
        ep["seed_inds"] = ep["fp2_inds"]
        ep["seed_xyz"] = ep["fp2_xyz"]
        with torch.no_grad():
            text_hidden = self.text_encoder(inputs["text_ids"],
                                            inputs["text_mask"])
        text = self.text_projector(text_hidden)
        text_pad = inputs["text_mask"] == 0
        ep["text_attention_mask"] = text_pad
        det = det_mask = None
        if self.butd:
            det = torch.cat([
                self.box_embeddings(inputs["det_boxes"].float()),
                self.class_embeddings(self.butd_class_embeddings(
                    inputs["det_class_ids"].long()))], dim=-1)
            det_mask = ~inputs["det_bbox_label_mask"].bool()
        xyz = ep["fp2_xyz"]
        pos = self.pos_embed(xyz)
        pad = torch.zeros(xyz.shape[:2], dtype=torch.bool, device=xyz.device)
        vis, text = self.cross_encoder(ep["fp2_features"], pos, pad, text,
                                       text_pad, det, det_mask)
        ep["text_memory"] = text
        ep["seed_features"] = vis
        ep["proj_tokens"] = l2_normalize(
            self.contrastive_align_projection_text(text))
        ep["seeds_obj_cls_logits"] = self.points_obj_cls(vis)
        return ep, (det, det_mask)

    def decode(self, ep, detected, sample_inds):
        det, det_mask = detected
        xyz = ops.gather_points(ep["fp2_xyz"], sample_inds)
        feats = ops.gather_points(ep["seed_features"], sample_inds)
        ep["query_points_sample_inds"] = sample_inds
        query = self.decoder_query_proj(feats)
        proj_inputs = [query]
        proposal = self.proposal_head(feats, xyz)
        for k, v in proposal.items():
            ep["proposal_" + k] = v
        base_xyz = proposal["center"].detach()
        base_size = proposal["pred_size"].detach()
        prefixes = prediction_prefixes(self.num_decoder_layers)
        for i, (layer, head) in enumerate(zip(self.decoder,
                                              self.prediction_heads)):
            query = layer(query, ep["seed_features"], ep["text_memory"],
                          torch.cat([base_xyz, base_size], dim=-1),
                          ep["text_attention_mask"], det, det_mask)
            proj_inputs.append(query)
            pred = head(query, xyz)
            for k, v in pred.items():
                ep[prefixes[i + 1] + k] = v
            base_xyz = pred["center"].detach()
            base_size = pred["pred_size"].detach()
        proj = l2_normalize(self.contrastive_align_projection_image(
            torch.cat(proj_inputs, dim=1)))
        V = self.num_queries
        for j, prefix in enumerate(prefixes):
            ep[f"{prefix}proj_queries"] = proj[:, j * V:(j + 1) * V]
        return ep

    def forward(self, inputs, sample_inds=None):
        ep, detected = self.encode(inputs)
        if sample_inds is None:
            sample_inds = top_k_stable(ep["seeds_obj_cls_logits"],
                                       self.num_queries)
        return self.decode(ep, detected, sample_inds.long())
