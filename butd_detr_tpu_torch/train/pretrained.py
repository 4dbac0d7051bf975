"""Pretrained initialisation for from-scratch training runs.

Counterpart of `butd_detr_tpu/train/pretrained.py`, with the same
functions and the same `report`. The reference never trains truly from
scratch (models/bdetr.py:60-94):
  * `backbone_net` starts from a GroupFree PointNet++ state dict passed as
    `--pp_checkpoint` (bdetr.py:66-71, loaded `strict=False` and only when
    the point cloud has exactly 3 extra channels — train_dist_mod.py:79-97);
  * `text_encoder` is HF-pretrained frozen `roberta-base` (bdetr.py:73-77);
  * `butd_class_embeddings` is the frozen class-name table generated into
    `data/class_embeddings3d.npy` (bdetr.py:86-92).

`apply_pretrained_init` reproduces all three on a built model, in place.
The port keeps the reference's torch parameter names, so each source loads
by name, with no flax-path mapping. Each source is optional and
failure-isolated: a missing file degrades to the random init with a loud
log line (the HF path reads only a local `transformers` cache).
"""

import os
import os.path as osp
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _to_numpy_state_dict(sd) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """torch.load a checkpoint file; unwrap common {model|state_dict}
    nesting and the DDP 'module.' prefix; return numpy tensors."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("model", "state_dict", "model_state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    sd = _to_numpy_state_dict(obj)
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in sd.items()
    }


# ---------------------------------------------------------------------------
# RoBERTa (reference bdetr.py:73-77)
# ---------------------------------------------------------------------------


def roberta_state_dict(source: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Obtain a roberta-base torch state dict.

    source=None  -> transformers local cache (offline; raises if absent,
                    or if `transformers` is not installed)
    source=dir   -> HF snapshot dir (pytorch_model.bin)
    source=file  -> torch checkpoint (.pth/.bin) or .npz of HF-named arrays
    """
    if source is None:
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        from transformers import RobertaModel as HFRoberta

        return _to_numpy_state_dict(HFRoberta.from_pretrained(
            "roberta-base", local_files_only=True).state_dict())
    if osp.isdir(source):
        for name in ("pytorch_model.bin", "model.pth", "model.npz"):
            cand = osp.join(source, name)
            if osp.exists(cand):
                source = cand
                break
        else:
            raise FileNotFoundError(f"no weights file under {source}")
    if source.endswith(".npz"):
        with np.load(source) as z:
            return {k: z[k] for k in z.files}
    return load_torch_state_dict(source)


def _copy_(param: torch.Tensor, value: np.ndarray) -> None:
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.ascontiguousarray(value))
                    .reshape(param.shape))


def init_text_encoder(model: nn.Module, source: Optional[str]) -> bool:
    """Replace `model.text_encoder`'s weights with pretrained roberta
    weights (HF names, with or without a leading 'roberta.'), in place.
    Every tensor of the module must be in the source, at its shape; the
    module's own layer count decides which layers are read. Returns whether
    it loaded."""
    text = getattr(model, "text_encoder", None)
    if text is None:
        return False
    sd = roberta_state_dict(source)

    def get(k):
        for kk in (k, "roberta." + k):
            if kk in sd:
                return np.asarray(sd[kk])
        raise KeyError(k)

    own = text.state_dict()
    new = {k: get(k) for k in own}
    for k, leaf in own.items():
        if tuple(new[k].shape) != tuple(leaf.shape):
            raise ValueError(f"roberta leaf {k}: shape {new[k].shape} vs "
                             f"template {tuple(leaf.shape)}")
    for k, leaf in own.items():
        _copy_(leaf, new[k])
    return True


# ---------------------------------------------------------------------------
# GroupFree PointNet++ backbone (reference bdetr.py:66-71)
# ---------------------------------------------------------------------------


def init_pointnet_backbone(model: nn.Module, path: str) -> Tuple[int, int]:
    """Load a GroupFree PointNet++ state dict into `model.backbone_net`
    (parameters and BatchNorm statistics) with the reference's
    `strict=False` semantics: a tensor whose key is absent, or whose shape
    differs, keeps its current value. A 1x1 convolution's weight is read as
    its (out, in) matrix, as the JAX package reads it. Returns (n_loaded,
    n_skipped), counted over the tensors the JAX package holds (BatchNorm's
    `num_batches_tracked` is not one)."""
    sd = load_torch_state_dict(path)
    # the released file addresses Pointnet2Backbone directly; normalize to
    # full-model keys
    sd = {
        (k if k.startswith("backbone_net.") else f"backbone_net.{k}"): v
        for k, v in sd.items()
    }
    backbone = getattr(model, "backbone_net", None)
    if backbone is None:
        return 0, 0
    loaded = skipped = 0
    for key, leaf in backbone.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        t = sd.get(f"backbone_net.{key}")
        if t is None:
            skipped += 1
            continue
        want = tuple(leaf.shape)
        if key.endswith("conv.weight"):  # (out, in, 1[, 1])
            t, want = t.reshape(t.shape[0], t.shape[1]), want[:2]
        if tuple(t.shape) != want:
            skipped += 1
            continue
        _copy_(leaf, t)
        loaded += 1
    return loaded, skipped


# ---------------------------------------------------------------------------
# class-name embedding table (reference bdetr.py:86-92)
# ---------------------------------------------------------------------------


def init_class_embeddings(model: nn.Module, path: str) -> bool:
    emb = getattr(model, "butd_class_embeddings", None)
    if emb is None:
        return False
    table = np.load(path, allow_pickle=True)
    if tuple(table.shape) != tuple(emb.weight.shape):
        raise ValueError(
            f"class_embeddings3d shape {table.shape} vs param "
            f"{tuple(emb.weight.shape)}"
        )
    _copy_(emb.weight, table)
    return True


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------


def apply_pretrained_init(model: nn.Module, cfg, logger=None,
                          roberta_config=None) -> Dict[str, str]:
    """Reproduce the reference's from-scratch initialization on a built
    model, in place. Returns the report, which maps each source to
    'loaded' / 'skipped (...)'. `roberta_config` is taken for the JAX
    signature; the text encoder's own layers decide what is read, as the
    template's layer count does there."""
    del roberta_config

    def log(msg):
        if logger is not None:
            logger.info(msg)

    report: Dict[str, str] = {}

    # 1. frozen roberta-base trunk
    try:
        ok = init_text_encoder(model, cfg.roberta_checkpoint)
        report["text_encoder"] = "loaded" if ok else "skipped (no module)"
    except Exception as e:  # no cache / no file: keep random init, loudly
        report["text_encoder"] = f"skipped ({type(e).__name__}: {e})"
    log(f"pretrained text_encoder: {report['text_encoder']}")

    # 2. GroupFree PointNet++ backbone — same gate as the reference
    #    (bdetr.py:68: input_feature_dim == 3, i.e. color, no height/mv)
    if cfg.pp_checkpoint and cfg.input_feature_dim == 3:
        try:
            n_ok, n_skip = init_pointnet_backbone(model, cfg.pp_checkpoint)
            report["backbone_net"] = f"loaded {n_ok} leaves, {n_skip} kept"
        except Exception as e:
            report["backbone_net"] = f"skipped ({type(e).__name__}: {e})"
    elif cfg.pp_checkpoint:
        report["backbone_net"] = (
            "skipped (input_feature_dim "
            f"{cfg.input_feature_dim} != 3, reference gate bdetr.py:68)"
        )
    else:
        report["backbone_net"] = "skipped (no pp_checkpoint)"
    log(f"pretrained backbone_net: {report['backbone_net']}")

    # 3. frozen class-name embedding table
    emb_path = cfg.class_embeddings_path or osp.join(
        cfg.data_root, "class_embeddings3d.npy"
    )
    if osp.exists(emb_path):
        try:
            ok = init_class_embeddings(model, emb_path)
            report["butd_class_embeddings"] = (
                "loaded" if ok else "skipped (not a butd model)"
            )
        except Exception as e:
            report["butd_class_embeddings"] = (
                f"skipped ({type(e).__name__}: {e})"
            )
    else:
        report["butd_class_embeddings"] = f"skipped (no file {emb_path})"
    log(f"pretrained butd_class_embeddings: {report['butd_class_embeddings']}")

    return report
