"""BeaUTyDETR, the 3D language-grounding model (reference models/bdetr.py;
JAX counterpart butd_detr_tpu/models/bdetr.py), in eval and train mode.

point cloud + tokenized text + detected-box stream -> `end_points` with the
reference's key schema (per-layer prefixes `proposal_`, `{i}head_`,
`last_`), channels-last. Parameter names are the reference torch names, so
a reference state dict loads with `load_state_dict`.

In train mode BatchNorm uses batch statistics and every dropout is live;
all of them draw from the model's one `DropoutRng` (`model.rng`), which a
trainer re-seeds once per step. The box estimates that feed the next
decoder layer's position embedding are detached, and the text tower runs
in eval mode under `no_grad` while `freeze_text` (the reference freezes
it unconditionally, bdetr.py:76-77).
"""

from typing import Dict

import torch
from torch import nn

from butd_detr_tpu_torch.lang.roberta import RobertaConfig, RobertaModel
from butd_detr_tpu_torch.models.decoder import BiDecoderLayer
from butd_detr_tpu_torch.models.encoder import BiEncoder
from butd_detr_tpu_torch.models.heads import (
    ClsAgnosticPredictHead,
    PointsObjClsModule,
    general_sampling,
)
from butd_detr_tpu_torch.nn.backbone import Pointnet2Backbone
from butd_detr_tpu_torch.nn.dropout import Dropout, DropoutRng, bind_rng
from butd_detr_tpu_torch.nn.mlp import PointwiseConv
from butd_detr_tpu_torch.nn.position import PositionEmbeddingLearned


def l2_normalize(x, eps=1e-12):
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                               eps)


def contrastive_projection(d_model: int, out_dim: int = 64) -> nn.Sequential:
    """3-layer MLP to the 64-d contrastive space (keys 0, 2, 4)."""
    return nn.Sequential(nn.Linear(d_model, d_model), nn.ReLU(),
                         nn.Linear(d_model, d_model), nn.ReLU(),
                         nn.Linear(d_model, out_dim))


def top_k_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, ties to the lower
    index (lax.top_k's order; torch.topk promises none)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def prediction_prefixes(num_decoder_layers: int):
    return (["proposal_"]
            + [f"{i}head_" for i in range(num_decoder_layers - 1)]
            + ["last_"])


class BeaUTyDETR(nn.Module):
    """`input_feature_dim` counts the per-point channels after xyz (3 with
    colour). `backbone_dtype` is the PointNet++ MLPs' compute dtype;
    `attn_precise` selects the attention kernel's f32 mode; `freeze_text`
    False lets gradients into the text tower."""

    def __init__(self, roberta: RobertaConfig, num_class: int = 256,
                 num_obj_class: int = 485, input_feature_dim: int = 3,
                 num_queries: int = 256, num_encoder_layers: int = 3,
                 num_decoder_layers: int = 6,
                 self_position_embedding: str = "loc_learned",
                 contrastive_align_loss: bool = True, d_model: int = 288,
                 butd: bool = True, self_attend: bool = True,
                 text_hidden: int = 768, box_emb_dim: int = 128,
                 backbone_npoints=(2048, 1024, 512, 256),
                 backbone_dtype=torch.float32, attn_precise: bool = False,
                 freeze_text: bool = True):
        super().__init__()
        if num_queries > backbone_npoints[1]:
            raise ValueError(
                f"num_queries {num_queries} exceeds the {backbone_npoints[1]} "
                "seed points the backbone returns (backbone_npoints[1])")
        d = d_model
        self.freeze_text = freeze_text
        self.num_queries = num_queries
        self.num_decoder_layers = num_decoder_layers
        self.self_position_embedding = self_position_embedding
        self.contrastive_align_loss = contrastive_align_loss
        self.butd = butd

        self.backbone_net = Pointnet2Backbone(
            input_feature_dim=input_feature_dim, output_dim=d,
            npoints=backbone_npoints, dtype=backbone_dtype)
        self.text_encoder = RobertaModel(roberta, precise=attn_precise)
        if freeze_text:
            self.text_encoder.requires_grad_(False)
        self.text_projector = nn.Sequential(
            nn.Linear(roberta.hidden_size, d), nn.LayerNorm(d, eps=1e-12),
            Dropout(0.1))
        if butd:
            self.butd_class_embeddings = nn.Embedding(num_obj_class,
                                                      text_hidden)
            self.box_embeddings = PositionEmbeddingLearned(6, box_emb_dim)
            self.class_embeddings = nn.Linear(text_hidden, d - box_emb_dim)
        self.pos_embed = PositionEmbeddingLearned(3, d)
        self.cross_encoder = BiEncoder(
            num_encoder_layers, d, 8, 256, 0.1, self_attend=self_attend,
            use_butd_enc_attn=butd, precise=attn_precise)
        if contrastive_align_loss:
            self.contrastive_align_projection_image = \
                contrastive_projection(d)
            self.contrastive_align_projection_text = \
                contrastive_projection(d)
        self.points_obj_cls = PointsObjClsModule(d)
        self.decoder_query_proj = PointwiseConv(d, d)
        self.proposal_head = ClsAgnosticPredictHead(num_class, d)
        self.decoder = nn.ModuleList(
            BiDecoderLayer(d, 8, 256, 0.1, self_position_embedding, butd,
                           precise=attn_precise)
            for _ in range(num_decoder_layers))
        self.prediction_heads = nn.ModuleList(
            ClsAgnosticPredictHead(num_class, d)
            for _ in range(num_decoder_layers))
        self.rng = bind_rng(self, DropoutRng())

    def forward(self, inputs: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        end_points, detected = self.encode(inputs)
        sample_inds = top_k_stable(end_points["seeds_obj_cls_logits"],
                                   self.num_queries).to(torch.int32)
        return self.decode(end_points, detected, sample_inds)

    def encode(self, inputs: Dict[str, torch.Tensor]):
        """Backbone, text tower, box stream, cross-encoder and the kps
        objectness logits: returns (end_points, (detected_feats,
        detected_mask)), the state query selection and `decode` need."""
        end_points: Dict[str, torch.Tensor] = {}

        # visual backbone
        ep = self.backbone_net(inputs["point_clouds"])
        end_points.update(ep)
        end_points["seed_inds"] = ep["fp2_inds"]
        end_points["seed_xyz"] = ep["fp2_xyz"]
        end_points["seed_features"] = ep["fp2_features"]

        # text backbone + projector; the tower has no dropout of its own
        # (the JAX model runs it with train=False, bdetr.py:129)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_text):
            text_hidden = self.text_encoder(inputs["text_ids"],
                                            inputs["text_mask"])
        text_feats = self.text_projector(text_hidden)
        text_padding_mask = inputs["text_mask"] == 0  # True == PAD
        end_points["text_feats"] = text_feats
        end_points["text_attention_mask"] = text_padding_mask

        points_xyz = ep["fp2_xyz"]
        points_features = ep["fp2_features"]

        # detected-box stream
        detected_feats = detected_mask = None
        if self.butd:
            box_emb = self.box_embeddings(inputs["det_boxes"].float())
            cls_emb = self.class_embeddings(self.butd_class_embeddings(
                inputs["det_class_ids"].long()))
            detected_feats = torch.cat([box_emb, cls_emb], dim=-1)
            detected_mask = ~inputs["det_bbox_label_mask"].bool()

        # cross-modal encoder
        pos_feats = self.pos_embed(points_xyz)
        vis_padding_mask = torch.zeros(points_xyz.shape[:2],
                                       dtype=torch.bool,
                                       device=points_xyz.device)
        points_features, text_feats = self.cross_encoder(
            points_features, pos_feats, vis_padding_mask, text_feats,
            text_padding_mask, detected_feats, detected_mask)
        end_points["text_memory"] = text_feats
        end_points["seed_features"] = points_features
        if self.contrastive_align_loss:
            end_points["proj_tokens"] = l2_normalize(
                self.contrastive_align_projection_text(text_feats))

        # query-selection scores (kps)
        end_points["seeds_obj_cls_logits"] = self.points_obj_cls(
            points_features)
        return end_points, (detected_feats, detected_mask)

    def decode(self, end_points: Dict[str, torch.Tensor], detected,
               sample_inds: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Gather the queries at `sample_inds` (B, num_queries), then the
        proposal head and the decoder with its heads; adds their end
        points to `end_points` and returns it."""
        detected_feats, detected_mask = detected
        points_xyz = end_points["fp2_xyz"]
        points_features = end_points["seed_features"]
        text_feats = end_points["text_memory"]
        text_padding_mask = end_points["text_attention_mask"]
        cluster_xyz, cluster_feature, sample_inds = general_sampling(
            points_xyz, points_features, sample_inds)
        end_points["query_points_xyz"] = cluster_xyz
        end_points["query_points_feature"] = cluster_feature
        end_points["query_points_sample_inds"] = sample_inds

        query = self.decoder_query_proj(cluster_feature)
        proj_inputs = [query] if self.contrastive_align_loss else None

        # proposal head
        proposal = self.proposal_head(cluster_feature, cluster_xyz)
        for k, v in proposal.items():
            end_points["proposal_" + k] = v
        base_xyz = proposal["center"].detach()
        base_size = proposal["pred_size"].detach()

        # decoder
        prefixes = prediction_prefixes(self.num_decoder_layers)[1:]
        for i, (layer, head) in enumerate(zip(self.decoder,
                                              self.prediction_heads)):
            if self.self_position_embedding == "none":
                query_pos = None
            elif self.self_position_embedding == "xyz_learned":
                query_pos = base_xyz
            else:
                query_pos = torch.cat([base_xyz, base_size], dim=-1)
            query = layer(query, points_features, text_feats, query_pos,
                          None, text_padding_mask, detected_feats,
                          detected_mask)
            if proj_inputs is not None:
                proj_inputs.append(query)
            pred = head(query, cluster_xyz)
            for k, v in pred.items():
                end_points[prefixes[i] + k] = v
            base_xyz = pred["center"].detach()
            base_size = pred["pred_size"].detach()

        if proj_inputs is not None:
            # all prefixes in one batched application of the shared MLP
            proj = l2_normalize(self.contrastive_align_projection_image(
                torch.cat(proj_inputs, dim=1)))
            V = self.num_queries
            for j, prefix in enumerate(
                    prediction_prefixes(self.num_decoder_layers)):
                end_points[f"{prefix}proj_queries"] = proj[:, j * V:(j + 1)
                                                           * V]
        return end_points
