"""Language-grounding evaluation.

Counterpart of `butd_detr_tpu/eval/grounding.py` (reference
`src/grounding_evaluator.py`: GroundingEvaluator:17,
GroundingGTEvaluator:256). The per-batch computation is one masked,
fixed-shape program over B and K on the end points' device; only the small
hit tensors come back to the host, in one copy per batch, where the
evaluators accumulate them.

Two scoring modes per reference:
  - ``bbs`` box-by-span: softmaxed 256-way soft-token scores dotted with the
    GT positive map (grounding_evaluator.py:110-166).
  - ``bbf`` box-by-contrast: projected query/token 64-d features, similarity
    / 0.07 softmax over tokens (grounding_evaluator.py:168-242).

Top-k and argmax break ties towards the lower index, as the JAX package's
`lax.top_k` and `argmax` do, so that both packages count the same hits.
"""

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from butd_detr_tpu_torch.losses.boxes import (
    box_cxcyczwhd_to_xyzxyz,
    matched_iou3d,
    pairwise_iou3d,
)
from butd_detr_tpu_torch.models.bdetr import top_k_stable
from butd_detr_tpu_torch.utils.dist import allreduce_dict

BREAKDOWN_FIELDS = ("easy", "hard", "vd", "vid", "unique", "multi")

# what the hit functions read besides the per-prefix predictions
_GT_KEYS = ("positive_map", "center_label", "size_gts", "box_label_mask",
            "proj_tokens", "all_bboxes", "all_bbox_label_mask")
_PRED_KEYS = ("sem_cls_scores", "proj_queries", "center", "pred_size")


def _parse_gt(end_points, only_root: bool):
    """Binarized positive map + GT cxcyczwhd boxes + object mask
    (grounding_evaluator.py:244-254): positive_map values > 0 become 1;
    with only_root, keep just the first (root-noun) object."""
    pmap = (end_points["positive_map"] > 0).float()  # (B, K, T)
    gt = torch.cat([end_points["center_label"][..., :3],
                    end_points["size_gts"]], dim=-1).float()  # (B, K, 6)
    mask = end_points["box_label_mask"].float()  # (B, K)
    if only_root:
        pmap, gt, mask = pmap[:, :1], gt[:, :1], mask[:, :1]
    return pmap, gt, mask


def _pad_scores(scores: torch.Tensor, width: int) -> torch.Tensor:
    """Right-pad the last dim with zeros to the positive map's width
    (grounding_evaluator.py:124-129)."""
    t = scores.shape[-1]
    if t < width:
        scores = F.pad(scores, (0, width - t))
    return scores[..., :width]


def span_scores(end_points, prefix: str, width: int) -> torch.Tensor:
    """(B, Q, width) softmaxed soft-token scores (`bbs`)."""
    s = torch.softmax(end_points[f"{prefix}sem_cls_scores"].float(), -1)
    return _pad_scores(s, width)


def contrast_scores(end_points, prefix: str, width: int,
                    temperature: float = 0.07) -> torch.Tensor:
    """(B, Q, width) contrastive query-token scores (`bbf`)."""
    sim = torch.einsum("bqd,btd->bqt",
                       end_points[f"{prefix}proj_queries"].float(),
                       end_points["proj_tokens"].float())
    return _pad_scores(torch.softmax(sim / temperature, -1), width)


def pred_boxes(end_points, prefix: str) -> torch.Tensor:
    """(B, Q, 6) cxcyczwhd."""
    return torch.cat([end_points[f"{prefix}center"].float(),
                      end_points[f"{prefix}pred_size"].float()], -1)


def topk_box_hits(sem_scores, pred_bbox, pmap, gt_bboxes,
                  thresholds: Sequence[float], topks: Sequence[int]):
    """For each (sample, object): did any of the top-k-scoring predicted
    boxes reach IoU > t with the GT box? (B, Q, T) probabilities, (B, Q, 6)
    and (B, K, 6) cxcyczwhd boxes, (B, K, T) binarized positive map ->
    (B, K, n_t, n_k) float hits (grounding_evaluator.py:138-166)."""
    kmax = max(topks)
    scores = torch.einsum("bqt,bkt->bkq", sem_scores, pmap)  # (B, K, Q)
    top_idx = top_k_stable(scores, kmax)  # (B, K, kmax)
    B, K = top_idx.shape[:2]
    pb = torch.gather(
        pred_bbox[:, None].expand(B, K, -1, 6), 2,
        top_idx[..., None].expand(-1, -1, -1, 6))  # (B, K, kmax, 6)
    ious = matched_iou3d(
        box_cxcyczwhd_to_xyzxyz(gt_bboxes)[:, :, None, :],
        box_cxcyczwhd_to_xyzxyz(pb))  # (B, K, kmax)
    hits = [torch.stack([(ious > t)[..., :k].any(dim=-1) for k in topks],
                        dim=-1) for t in thresholds]
    return torch.stack(hits, dim=2).float()  # (B, K, n_t, n_k)


def grounding_batch_hits(end_points: Dict, prefixes: Sequence[str],
                         thresholds: Sequence[float] = (0.25, 0.5),
                         topks: Sequence[int] = (1, 5, 10),
                         only_root: bool = True, width: int = 256,
                         with_contrast: bool = True):
    """All hit tensors of one batch: per prefix and mode (B, K, n_t, n_k),
    the object mask (B, K), and the root object's bbf top-1 hits at
    thresholds[0] (B,) for the easy/hard/vd/vid/unique/multi breakdown
    (grounding_evaluator.py:216-242, last_ prefix only)."""
    pmap, gt, mask = _parse_gt(end_points, only_root)
    out = {"mask": mask}
    for prefix in prefixes:
        pred = pred_boxes(end_points, prefix)
        out[prefix + "bbs"] = topk_box_hits(
            span_scores(end_points, prefix, width), pred, pmap, gt,
            thresholds, topks)
        if with_contrast:
            out[prefix + "bbf"] = topk_box_hits(
                contrast_scores(end_points, prefix, width), pred, pmap, gt,
                thresholds, topks)
    if with_contrast and "last_" in prefixes:
        out["root_found"] = out["last_bbf"][:, 0, 0, 0]
    return out


def gt_grounding_batch_hits(end_points: Dict, prefixes: Sequence[str],
                            width: int = 256, with_contrast: bool = True):
    """GT-box (cls setup) evaluation of one batch
    (grounding_evaluator.py:330-484): predictions are scored, suppressed
    where no scene GT box overlaps > 0.25, then the top-1 prediction is
    snapped to the nearest scene GT box; a hit is exact equality with the
    root target box. Per-sample hits (B,) per prefix and mode, the root
    mask and 'root_found'."""
    pmap, gt, mask = _parse_gt(end_points, only_root=True)
    all_boxes = end_points["all_bboxes"].float()  # (B, M, 6)
    all_mask = end_points["all_bbox_label_mask"].bool()  # (B, M)
    all_xyz = box_cxcyczwhd_to_xyzxyz(all_boxes)

    out = {}
    for prefix in prefixes:
        pred = pred_boxes(end_points, prefix)  # (B, Q, 6)
        ious, _ = pairwise_iou3d(all_xyz, box_cxcyczwhd_to_xyzxyz(pred))
        ious = torch.where(all_mask[:, :, None], ious,
                           torch.zeros_like(ious))  # (B, M, Q)
        is_correct = (ious.amax(dim=1) > 0.25).float()  # (B, Q)

        modes = {"bbs": span_scores(end_points, prefix, width)}
        if with_contrast:
            modes["bbf"] = contrast_scores(end_points, prefix, width)
        for m, s in modes.items():
            scores = torch.einsum("bqt,bkt->bkq", s, pmap)[:, 0]  # (B, Q)
            top = torch.argmax(scores * is_correct, dim=-1)  # (B,)
            pbox = torch.gather(pred, 1,
                                top[:, None, None].expand(-1, 1, 6))
            snap_iou, _ = pairwise_iou3d(
                all_xyz, box_cxcyczwhd_to_xyzxyz(pbox))  # (B, M, 1)
            snap_iou = torch.where(all_mask[:, :, None], snap_iou,
                                   torch.full_like(snap_iou, -1.0))
            best = torch.argmax(snap_iou[:, :, 0], dim=-1)  # (B,)
            snapped = torch.gather(
                all_boxes, 1, best[:, None, None].expand(-1, 1, 6))[:, 0]
            out[prefix + m] = (snapped == gt[:, 0]).all(dim=-1).float()
    out["mask"] = mask[:, 0]
    if with_contrast and "last_" in prefixes:
        out["root_found"] = out["last_bbf"]
    return out


def _on_device(end_points: Dict, prefixes: Sequence[str]) -> Dict:
    """The entries the hit functions read, as tensors on the predictions'
    device (numpy arrays of the batch are moved there; nothing already on
    the device moves)."""
    first = end_points[f"{prefixes[0]}center"]
    device = first.device if isinstance(first, torch.Tensor) else "cpu"
    keys = [k for k in _GT_KEYS if k in end_points]
    keys += [p + k for p in prefixes for k in _PRED_KEYS
             if p + k in end_points]
    return {k: torch.as_tensor(end_points[k]).to(device) for k in keys}


def _to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Every hit tensor in one device-to-host copy."""
    flat = torch.cat([v.reshape(-1).float() for v in out.values()]).cpu()
    parts = torch.split(flat, [v.numel() for v in out.values()])
    return {k: p.reshape(v.shape).numpy()
            for (k, v), p in zip(out.items(), parts)}


class GroundingEvaluator:
    """Accumulates Top-{1,5,10} Acc@{0.25,0.5} per layer prefix, both modes,
    plus easy/hard/view-dep/unique breakdowns: a host-side accumulator
    around `grounding_batch_hits`.

    API as the reference GroundingEvaluator (grounding_evaluator.py:17):
    evaluate(end_points) [all prefixes at once],
    synchronize_between_processes(), print_stats(), reset().
    """

    def __init__(self, only_root: bool = True,
                 thresholds: Sequence[float] = (0.25, 0.5),
                 topks: Sequence[int] = (1, 5, 10),
                 prefixes: Sequence[str] = (), with_contrast: bool = True,
                 logger=None):
        self.only_root = only_root
        self.thresholds = tuple(thresholds)
        self.topks = tuple(topks)
        self.prefixes = list(prefixes)
        self.with_contrast = with_contrast
        self.modes = ["bbs", "bbf"] if with_contrast else ["bbs"]
        self._log = logger.info if logger is not None else print
        self.reset()

    def reset(self):
        self.dets = {(p, t, k, m): 0.0 for p in self.prefixes
                     for t in self.thresholds for k in self.topks
                     for m in self.modes}
        self.gts = dict(self.dets)
        for f in BREAKDOWN_FIELDS:
            self.dets[f] = 0.0
            self.gts[f] = 1e-14

    @torch.no_grad()
    def _hits(self, end_points: Dict) -> Dict[str, np.ndarray]:
        return _to_host(grounding_batch_hits(
            _on_device(end_points, self.prefixes), tuple(self.prefixes),
            self.thresholds, self.topks, self.only_root,
            with_contrast=self.with_contrast))

    def evaluate(self, end_points: Dict):
        """end_points: tensors (any device) or numpy arrays of one batch,
        all prefixes."""
        out = self._hits(end_points)
        mask = out["mask"]  # (B, K)
        n = mask.sum()
        for p in self.prefixes:
            for m in self.modes:
                hits = out[p + m]  # (B, K, n_t, n_k)
                for it, t in enumerate(self.thresholds):
                    for ik, k in enumerate(self.topks):
                        self.dets[(p, t, k, m)] += float(
                            (hits[:, :, it, ik] * mask).sum())
                        self.gts[(p, t, k, m)] += float(n)
        if "root_found" in out:
            self._breakdown(end_points, out["root_found"], mask[:, 0])

    def _breakdown(self, end_points, found, root_mask):
        flags = {"vd": "is_view_dep", "hard": "is_hard",
                 "unique": "is_unique"}
        inverse = {"vd": "vid", "hard": "easy", "unique": "multi"}
        for field, key in flags.items():
            if key not in end_points:
                continue
            flag = end_points[key]
            if isinstance(flag, torch.Tensor):
                flag = flag.cpu().numpy()
            flag = np.asarray(flag).astype(bool)
            pos = flag * root_mask
            neg = (~flag) * root_mask
            self.dets[field] += float((found * pos).sum())
            self.gts[field] += float(pos.sum())
            self.dets[inverse[field]] += float((found * neg).sum())
            self.gts[inverse[field]] += float(neg.sum())

    def synchronize_between_processes(self):
        self.dets = allreduce_dict(self.dets)
        self.gts = allreduce_dict(self.gts)

    def accuracy(self, prefix: str, t: float, k: int, mode: str = "bbf"):
        return self.dets[(prefix, t, k, mode)] / max(
            self.gts[(prefix, t, k, mode)], 1)

    def print_stats(self):
        mode_str = {"bbs": "Box given span (soft-token)",
                    "bbf": "Box given span (contrastive)"}
        for p in self.prefixes:
            for m in self.modes:
                for t in self.thresholds:
                    accs = ", ".join(
                        "Top-%d: %.3f" % (k, self.accuracy(p, t, k, m))
                        for k in self.topks)
                    self._log(f"{p} {mode_str[m]} Acc{t:.2f}: {accs}")
        self._log("Analysis")
        for f in BREAKDOWN_FIELDS:
            self._log(f"{f} {self.dets[f] / self.gts[f]:.4f}")


class GroundingGTEvaluator(GroundingEvaluator):
    """Exact-match accuracy under GT-box snapping (cls / gt setups)."""

    def __init__(self, prefixes=(), with_contrast: bool = True, logger=None):
        self.prefixes = list(prefixes)
        self.with_contrast = with_contrast
        self.modes = ["bbs", "bbf"] if with_contrast else ["bbs"]
        self._log = logger.info if logger is not None else print
        self.reset()

    def reset(self):
        self.dets = {(p, m): 0.0 for p in self.prefixes for m in self.modes}
        self.gts = dict(self.dets)
        for f in BREAKDOWN_FIELDS:
            self.dets[f] = 0.0
            self.gts[f] = 1e-14

    @torch.no_grad()
    def _hits(self, end_points: Dict) -> Dict[str, np.ndarray]:
        return _to_host(gt_grounding_batch_hits(
            _on_device(end_points, self.prefixes), tuple(self.prefixes),
            with_contrast=self.with_contrast))

    def evaluate(self, end_points: Dict):
        out = self._hits(end_points)
        mask = out["mask"]  # (B,)
        for p in self.prefixes:
            for m in self.modes:
                self.dets[(p, m)] += float((out[p + m] * mask).sum())
                self.gts[(p, m)] += float(mask.sum())
        if "root_found" in out:
            self._breakdown(end_points, out["root_found"], mask)

    def accuracy(self, prefix: str, mode: str = "bbf", **_):
        return self.dets[(prefix, mode)] / max(self.gts[(prefix, mode)], 1)

    def print_stats(self):
        mode_str = {"bbs": "Box given span (soft-token)",
                    "bbf": "Box given span (contrastive)"}
        for p in self.prefixes:
            for m in self.modes:
                self._log(f"{p} {mode_str[m]} Acc: {self.accuracy(p, m):.4f}")
        self._log("Analysis")
        for f in BREAKDOWN_FIELDS:
            self._log(f"{f} {self.dets[f] / self.gts[f]:.4f}")
