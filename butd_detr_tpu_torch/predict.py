"""Inference API: (scene, utterance[, phrase, detected boxes]) -> grounded
3D boxes, on the GPU.

Counterpart of `butd_detr_tpu/predict.py`. `GroundingPredictor` runs the
eval-mode BeaUTyDETR forward (FPS, ball query and attention as CUDA
kernels on `cuda`), scores the queries against the phrase's token span —
`bbs` (softmaxed soft-token scores) or `bbf` (contrastive query-token
similarity) — and returns the top-k boxes (cxcyczwhd) with their scores.
It runs on `cuda` unless the caller passes `device="cpu"`.
`GroundingPredictor.from_checkpoint` loads the weights from a `.pth` file:
the port's `ckpt_epoch_E.pth` (train/checkpoint.py) or a reference
checkpoint (`predict_torch.py` is the command line).

The host helpers `token_positive_map` and `MEAN_RGB` are the port's data
pipeline's (data/positive_map.py, data/augment.py); the scorers
`span_scores`, `contrast_scores` and `pred_boxes` are the port's
evaluators' (eval/grounding.py).
"""

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.data.augment import MEAN_RGB
from butd_detr_tpu_torch.data.positive_map import NUM_BINS, \
    token_positive_map
from butd_detr_tpu_torch.eval.grounding import (
    contrast_scores,
    pred_boxes,
    span_scores,
)
from butd_detr_tpu_torch.init import init_weights_
from butd_detr_tpu_torch.lang.roberta import RobertaConfig, \
    roberta_base_config
from butd_detr_tpu_torch.lang.tokenizer import SimpleTokenizer
from butd_detr_tpu_torch.models.bdetr import BeaUTyDETR


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller asks for another device; raises when CUDA
    is asked for (or defaulted to) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


# ------------------------------------------------------------ inputs

def prepare_point_cloud(pc: np.ndarray, num_points: int, use_color: bool,
                        use_height: bool = False,
                        rng: Optional[np.random.RandomState] = None
                        ) -> np.ndarray:
    """(N, 3) or (N, 6 xyz+rgb in [0, 1]) -> (num_points, C) model input:
    mean-RGB subtraction, optional height, fixed-size subsample (with
    replacement when the scene is smaller)."""
    rng = rng or np.random.RandomState(1184)
    pc = np.asarray(pc, np.float32)
    n = pc.shape[0]
    choice = (rng.choice(n, num_points, replace=n < num_points)
              if n != num_points else np.arange(n))
    pc = pc[choice]
    feats = [pc[:, :3]]
    if use_color:
        if pc.shape[1] < 6:
            raise ValueError("use_color requires an (N, 6) xyz+rgb cloud")
        feats.append(pc[:, 3:6] - MEAN_RGB)
    if use_height:
        floor = np.percentile(pc[:, 2], 0.99)
        feats.append((pc[:, 2] - floor)[:, None])
    return np.concatenate(feats, axis=1).astype(np.float32)


def build_model(cfg: Config, roberta_config: RobertaConfig,
                backbone_npoints=(2048, 1024, 512, 256)) -> BeaUTyDETR:
    """The model of `cfg`, on the CPU, parameters not yet filled (f32).

    Every entry point (`GroundingPredictor`, `Trainer`, `TrainTester`)
    builds its model here. `--use_bf16` makes bf16 the compute dtype of
    the whole model and `--backbone_bf16` that of the backbone's MLPs;
    without it the backbone computes in the model's dtype, as the JAX
    package's `build_model` has it (train/step.py)."""
    return BeaUTyDETR(
        roberta_config,
        num_class=256,
        num_obj_class=485,
        input_feature_dim=cfg.input_feature_dim,
        num_queries=cfg.num_target,
        num_encoder_layers=cfg.num_encoder_layers,
        num_decoder_layers=cfg.num_decoder_layers,
        self_position_embedding=cfg.self_position_embedding,
        contrastive_align_loss=cfg.use_contrastive_align,
        d_model=288,
        butd=cfg.use_butd,
        self_attend=cfg.self_attend,
        backbone_npoints=tuple(backbone_npoints),
        dtype=torch.bfloat16 if cfg.use_bf16 else torch.float32,
        backbone_dtype=torch.bfloat16 if cfg.backbone_bf16 else None,
        attn_precise=cfg.attn_precise,
        freeze_text=cfg.freeze_text_encoder,
    )


class GroundingPredictor:
    """Single-scene grounding inference.

    cfg: the model and input flags (`config.butd_cls_config()` for the
        SR3D butd_cls setup).
    tokenizer: `__call__`/`char_to_token` surface; defaults to
        SimpleTokenizer over the RoBERTa vocabulary size.
    state_dict: reference-named weights (e.g. a reference `.pth`'s
        `model` entry, or `convert.state_dict_from_jax`); None fills the
        model with seeded random weights from `seed`.
    device: `cuda` unless given.
    """

    def __init__(self, cfg: Config, tokenizer=None, state_dict=None, *,
                 roberta_config: Optional[RobertaConfig] = None,
                 backbone_npoints=(2048, 1024, 512, 256), device=None,
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        roberta_config = roberta_config or roberta_base_config()
        self.tokenizer = tokenizer or SimpleTokenizer(
            vocab_size=roberta_config.vocab_size, max_len=cfg.max_text_len)
        model = build_model(cfg, roberta_config, backbone_npoints)
        if state_dict is None:
            init_weights_(model, seed)
        else:
            load_state_dict(model, state_dict)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, cfg: Config, path: str, tokenizer=None, **kw
                        ) -> "GroundingPredictor":
        """The predictor with the weights of the `.pth` file at `path`: the
        `model` entry of the port's `ckpt_epoch_E.pth` or of a reference
        checkpoint (whose keys may carry a DDP `module.` prefix, and whose
        `config` entry is an `argparse.Namespace`), or a bare state dict.
        `kw` goes to the constructor (`roberta_config`, `backbone_npoints`,
        `device`). A directory, which would be the JAX package's orbax
        checkpoint, raises `ValueError`: it cannot be read without JAX."""
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is a directory (an orbax checkpoint of the JAX "
                "package?); the port reads .pth files only")
        with torch.serialization.safe_globals([argparse.Namespace]):
            payload = torch.load(path, map_location="cpu", weights_only=True)
        return cls(cfg, tokenizer, payload.get("model", payload), **kw)

    def _span_map(self, utterance: str, phrase: str) -> np.ndarray:
        """(1, 256) binarized token map of `phrase` inside `utterance`."""
        if phrase.lower() not in utterance.lower():
            raise ValueError(
                f"phrase {phrase!r} not found in utterance {utterance!r}")
        _, pmap = token_positive_map(self.tokenizer, utterance, [phrase],
                                     max_num_obj=1)
        if pmap[0, :self.cfg.max_text_len].sum() == 0:
            raise ValueError(
                f"phrase {phrase!r}: its tokens fall past max_text_len "
                f"({self.cfg.max_text_len}) in {utterance!r}")
        return (pmap > 0).astype(np.float32)

    def make_inputs(self, point_cloud: np.ndarray, utterance: str,
                    det_boxes: Optional[np.ndarray] = None,
                    det_class_ids: Optional[Sequence[int]] = None
                    ) -> Dict[str, torch.Tensor]:
        """The model's batch-of-one inputs, on the predictor's device."""
        cfg = self.cfg
        pc = prepare_point_cloud(point_cloud, cfg.num_points, cfg.use_color,
                                 cfg.use_height)
        tok = self.tokenizer([utterance], max_len=cfg.max_text_len)
        G = cfg.max_det_boxes
        boxes = np.zeros((G, 6), np.float32)
        mask = np.zeros((G,), bool)
        cids = np.zeros((G,), np.int64)
        if det_boxes is not None:
            d = min(len(det_boxes), G)
            boxes[:d] = np.asarray(det_boxes, np.float32)[:d]
            mask[:d] = True
            if det_class_ids is not None:
                cids[:d] = np.asarray(det_class_ids)[:d]
        arrays = {
            "point_clouds": pc[None],
            "text_ids": np.asarray(tok.ids, np.int64),
            "text_mask": np.asarray(tok.attention_mask, np.int64),
            "det_boxes": boxes[None],
            "det_bbox_label_mask": mask[None],
            "det_class_ids": cids[None],
        }
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in arrays.items()}

    @torch.inference_mode()
    def predict(self, point_cloud: np.ndarray, utterance: str,
                phrase: Optional[str] = None,
                det_boxes: Optional[np.ndarray] = None,
                det_class_ids: Optional[Sequence[int]] = None,
                mode: str = "bbf", top_k: int = 10) -> Dict[str, np.ndarray]:
        """Ground `phrase` (default: the whole utterance) in the scene.

        point_cloud: (N, 3) xyz or (N, 6) xyz+rgb in [0, 1]; det_boxes:
        optional (D, 6) cxcyczwhd detected-box stream with class ids.
        Returns {"boxes": (top_k, 6), "scores": (top_k,),
        "query_index": (top_k,)} as numpy arrays."""
        if mode not in ("bbf", "bbs"):
            raise ValueError(f"unknown mode {mode!r} (use 'bbf' or 'bbs')")
        if mode == "bbf" and not self.cfg.use_contrastive_align:
            raise ValueError("mode='bbf' needs use_contrastive_align=True;"
                             " use mode='bbs'")
        pmap = self._span_map(utterance, phrase or utterance.rstrip(". "))
        ep = self.model(self.make_inputs(point_cloud, utterance, det_boxes,
                                         det_class_ids))
        # (1, Q, 256); `bbf` divides by the temperature, as the JAX
        # predictor's eager call does
        s = (contrast_scores(ep, "last_", NUM_BINS, divide=True)
             if mode == "bbf" else span_scores(ep, "last_", NUM_BINS))
        q_scores = torch.einsum(
            "bqt,kt->bkq", s, torch.from_numpy(pmap).to(s.device)
        )[0, 0].cpu().numpy()
        order = np.argsort(-q_scores)[:top_k]
        boxes = pred_boxes(ep, "last_")[0].cpu().numpy()
        return {"boxes": boxes[order], "scores": q_scores[order],
                "query_index": order}


def load_state_dict(model: torch.nn.Module, state_dict) -> list:
    """Load reference-named weights (a DDP `module.` prefix is dropped).
    Every model parameter and buffer must be found; returns the reference
    keys the model does not use (e.g. RoBERTa's pooler)."""
    sd = {(k[len("module."):] if k.startswith("module.") else k):
          torch.as_tensor(v) for k, v in state_dict.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"state dict lacks {len(missing)} model keys, "
                       f"e.g. {missing[:5]}")
    return sorted(unexpected)
