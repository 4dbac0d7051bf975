"""The comparison that decides `correct`: what the timed entries produced,
against the reference model (`benchmark/reference/`, plain PyTorch in
float32 with TF32 off), at the timed sizes.

The reference follows the program's discrete decisions where a rounding can
flip one (which 256 of the 1,024 seeds become queries, the Hungarian
matching) and judges each of them apart, by the gap that the program's
choice leaves on the reference's own scores:
  * `kps_gap`: by how much the best seed left out outscores the worst seed
    taken, over the reference's objectness scores, in their standard
    deviations (0 where the program took the reference's top 256);
  * `match_gap`: by how much the program's matching costs more than the
    optimum on the reference's cost matrices, in each matrix's spread;
  * `fps_mismatch`: sampled indices of the first two set-abstraction
    tiers that differ (the kernels promise the reference's bits).
On that footing it compares
  * training (the first three steps, through the window's own entry):
    `loss_gap`, the widest relative gap of a step's loss; `grad_gap`, the
    first gradient as the optimizer got it (from AdamW's first moment
    after step 1), and `update_gap`, the parameters' change over the three
    steps: each the median leaf's gap between the program's and the
    reference's norm of a leaf, over the larger of the reference leaf's norm
    and the median leaf's. Leaves whose reference gradient lies under a
    thousandth of the median leaf's are left out (they move under AdamW by
    round-off); `out_gap`, the first step's answers' widest gap, and
    `head_gap`, the same where the reference is handed the program's own
    backbone output;
  * evaluation (batches of the window drawn from the seed): over the
    answers (every layer's boxes, scores and projected queries, the
    projected tokens, the objectness scores), each answer's widest gap in
    the reference tensor's largest magnitude: `out_gap`, the median
    answer's, and `answer_gap`, the widest answer's; with the loss
    `loss_gap`; and `hits_diff`,
    how far the counts the program's evaluator added for the batch lie
    from the reference evaluator's counts on the same end points (exact).
A cell on several GPUs runs the training comparison on every rank, each
over its own rows with BatchNorm statistics, the box count and the
gradients the ranks' (`train_numbers(..., group=)`), and judges the widest
reading over the ranks; besides, `replica_gap`: the widest difference
between rank 0's parameters and BatchNorm buffers after the three steps
and another rank's (exact: an all-reduce hands every rank the same sum).
"""

import math
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from benchmark.harness.weights import reference_model
from benchmark.reference.evaluate import gt_counts, topk_counts
from benchmark.reference.loss import (
    assignment_excess,
    costs_by_prefix,
    hungarian_loss,
)
from benchmark.reference.model import BatchNorm, prediction_prefixes

TARGETS = ("center_label", "size_gts", "positive_map", "box_label_mask",
           "point_instance_label", "text_mask")
MODEL_INPUTS = ("point_clouds", "text_ids", "text_mask", "det_boxes",
                "det_class_ids", "det_bbox_label_mask")


def strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _build(config, weights, device):
    strict_fp32()
    model = reference_model(config, device=device)
    model.load_state_dict(weights)
    return model


def kps_gap(ref_logits: torch.Tensor, chosen: torch.Tensor) -> float:
    """Widest gap, over rows, by which a seed left out outscores a seed
    taken, in the row's standard deviation of reference scores."""
    if chosen.shape[0] != ref_logits.shape[0]:
        return math.inf
    s = ref_logits.float()
    taken = torch.zeros_like(s, dtype=torch.bool)
    taken.scatter_(1, chosen.long().to(s.device), True)
    worst_in = torch.where(taken, s, torch.full_like(s, math.inf)).amin(1)
    best_out = torch.where(taken, torch.full_like(s, -math.inf), s).amax(1)
    gap = (best_out - worst_in).clamp_min(0) / s.std(dim=1).clamp_min(1e-12)
    return float(gap.max())


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|; infinite where shapes differ."""
    got = torch.as_tensor(got)
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    got = got.to(want.device).float()
    want = want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-12))


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: List[str]) -> Dict[str, float]:
    """{leaf: |‖prog leaf‖ - ‖ref leaf‖| over max(‖ref leaf‖, the median
    leaf's norm)} over the leaves `keep`."""
    pn = {k: float(prog[k].float().norm()) for k in keep}
    rn = {k: float(ref[k].float().norm()) for k in keep}
    med = float(np.median(list(rn.values())))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep}


def _fps_mismatch(prog: Dict, ref_ep: Dict) -> int:
    n = 0
    for k in ("sa1_inds", "sa2_inds"):
        a = torch.as_tensor(prog[k]).long().cpu()
        b = ref_ep[k].long().cpu()
        n += int((a != b).sum()) if a.shape == b.shape else b.numel()
    return n


def _batch_on(batch: Dict, keys, device) -> Dict[str, torch.Tensor]:
    return {k: batch[k].to(device) for k in keys if k in batch}


def _mean_over_ranks(tensors: List[torch.Tensor], group
                     ) -> List[torch.Tensor]:
    """Each tensor's mean over the ranks of `group`, in one all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return [v.view_as(t) for t, v in zip(
        tensors, flat.split([t.numel() for t in tensors]))]


# ------------------------------------------------------------- training

@torch.no_grad()
def after_backbone_gap(model, rec: Dict, x: Dict, seed: int, P: int,
                       device) -> float:
    """The widest gap of the step's answers where the reference's text
    tower, encoder, decoder and heads are handed the program's own
    backbone output (and its query selection), with the step's dropout
    draws: the stages after the backbone, compared alone. (In training the
    bf16 PointNet++ MLPs under the batch's BatchNorm statistics lead the
    gap of the whole forward, and would hide the rest.)"""
    model.rng.seed(seed)
    backbone = {k: rec[k].to(device) for k in
                ("fp2_features", "fp2_xyz", "fp2_inds")}
    backbone = {k: v.float() if v.is_floating_point() else v
                for k, v in backbone.items()}
    ep, det = model.encode(x, backbone=backbone)
    ep = model.decode(ep, det, rec["query_points_sample_inds"].long()
                      .to(device))
    return max(rel_gap(rec[k], ep[k]) for k in output_keys(P))


def train_numbers(config: Dict, weights: Dict, batches: List[Dict],
                  seeds: List[int], program: Dict, device,
                  group=None) -> Dict[str, float]:
    """Three reference training steps from `weights` on `batches`,
    dropout seeded with `seeds`, against `program`: {"losses": [3],
    "first_grad": {name:}, "after": {name: the parameters after the three
    steps}, "forward": [recorded], "matches": [recorded]}.

    With a process `group` every rank of it calls this on its own rows:
    BatchNorm statistics and the box count are the group's, the gradients
    its mean, and the loss compared the mean of the ranks' losses."""
    model = _build(config, weights, device)
    model.train()
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    opt = config["optimizer"]
    lr = {n: opt["lr_backbone"] if "backbone_net" in n else opt["lr"]
          for n, _ in params}
    b1, b2 = opt["betas"]
    m = {n: torch.zeros_like(p) for n, p in params}
    v = {n: torch.zeros_like(p) for n, p in params}
    P = config["model"]["num_decoder_layers"] + 1
    out = {"kps_gap": 0.0, "match_gap": 0.0, "fps_mismatch": 0,
           "loss_gap": 0.0}
    steps = {"kps": [], "match": [], "loss": []}
    first_grad = None
    for i, batch in enumerate(batches):
        model.rng.seed(seeds[i])
        for _, p in params:
            p.grad = None
        x = _batch_on(batch, MODEL_INPUTS, device)
        rec = program["forward"][i]
        if rec["query_points_sample_inds"].shape[0] != \
                x["point_clouds"].shape[0]:
            return {k: math.inf for k in (
                "kps_gap", "match_gap", "fps_mismatch", "loss_gap",
                "grad_gap", "update_gap", "out_gap", "head_gap")}
        ep, det = model.encode(x)
        out["fps_mismatch"] += _fps_mismatch(rec, ep)
        steps["kps"].append(kps_gap(ep["seeds_obj_cls_logits"].detach(),
                                    rec["query_points_sample_inds"]))
        ep = model.decode(ep, det, rec["query_points_sample_inds"].long()
                          .to(device))
        if i == 0:
            out["out_gap"] = max(rel_gap(rec[k], ep[k].detach())
                                 for k in output_keys(P))
            # the backward keeps the masks it drew; the next step reseeds
            out["head_gap"] = after_backbone_gap(model, rec, x, seeds[0], P,
                                                 device)
        ep.update(_batch_on(batch, TARGETS, device))
        B, G = ep["box_label_mask"].shape
        match = program["matches"][i].reshape(P, B, G).to(device)
        with torch.no_grad():
            costs = costs_by_prefix(ep, P - 1)
            steps["match"].append(max(
                assignment_excess(costs[j], match[j], ep["box_label_mask"])
                for j in range(P)))
        loss, _ = hungarian_loss(ep, match, P - 1, group=group)
        loss.backward()
        value = loss.item() if group is None else \
            _mean_over_ranks([loss.detach()], group)[0].item()
        steps["loss"].append(abs(program["losses"][i] - value)
                             / max(abs(value), 1e-30))
        with torch.no_grad():
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in params}
            if group is not None:
                grads = dict(zip(grads, _mean_over_ranks(
                    list(grads.values()), group)))
            norm = torch.linalg.vector_norm(torch.stack(
                [g.norm() for g in grads.values()]))
            scale = 1.0 if norm < opt["clip_norm"] else \
                opt["clip_norm"] / norm
            for n, p in params:
                g = grads[n] * scale
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                t = i + 1
                p.mul_(1 - lr[n] * opt["weight_decay"])
                denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(
                    opt["eps"])
                p.addcdiv_(m[n], denom, value=-lr[n] / (1 - b1 ** t))
            if i == 0:
                first_grad = {n: grads[n] * scale for n, _ in params}
    with torch.no_grad():
        change = {n: p.detach() - weights[n] for n, p in params}
    norms = {n: float(g.norm()) for n, g in first_grad.items()}
    med = float(np.median(list(norms.values())))
    keep = [n for n in norms if norms[n] >= 1e-3 * med]
    grad_p = {n: program["first_grad"][n].to(device) for n in keep}
    change_p = {n: program["after"][n].to(device) - weights[n]
                for n in keep}
    g = leaf_gaps(grad_p, first_grad, keep)
    u = leaf_gaps(change_p, change, keep)
    # the median leaf: the widest leaf is a leaf of a few entries whose
    # gradient cancels over the batch, and reads a tenth on every seed
    out["grad_gap"] = float(np.median(list(g.values())))
    out["update_gap"] = float(np.median(list(u.values())))
    out["grad_gap_widest"], out["update_gap_widest"] = max(g.values()), \
        max(u.values())
    out["grad_gap_widest_leaf"] = max(g, key=g.get)
    out["update_gap_widest_leaf"] = max(u, key=u.get)
    # the look behind the widest leaf: the change over the elements whose
    # own reference gradient reaches a thousandth of the median leaf's
    # root mean square (a key's bias under softmax has none such), for the
    # log
    rms = float(np.median([norms[n] / math.sqrt(first_grad[n].numel())
                           for n in keep]))
    moved = {n: first_grad[n].abs() >= 1e-3 * rms for n in keep}
    um = leaf_gaps({n: change_p[n] * moved[n] for n in keep},
                   {n: change[n] * moved[n] for n in keep}, keep)
    out["update_gap_widest_moved"] = max(um.values())
    out["update_gap_widest_moved_leaf"] = max(um, key=um.get)
    out["elements_left_out"] = int(sum(int((~moved[n]).sum())
                                       for n in keep))
    # the loss over the three steps; the selection and the matching on the
    # first (AdamW's normalised first step moves both sides apart by round-
    # off in the smallest gradients, and the later steps' choices with it)
    out["loss_gap"] = max(steps["loss"])
    out["kps_gap"], out["match_gap"] = steps["kps"][0], steps["match"][0]
    for k, v in steps.items():
        out[f"{k}_gap_by_step"] = v
    out["leaves_compared"] = len(keep)
    out["leaves_left_out"] = len(norms) - len(keep)
    return out


# ----------------------------------------------------------- evaluation

OUT_KEYS = ("center", "pred_size", "sem_cls_scores", "proj_queries")


def output_keys(P: int) -> List[str]:
    """The answers compared: every layer's boxes, scores and projected
    queries, the projected tokens and the objectness scores."""
    return ["proj_tokens", "seeds_obj_cls_logits"] + [
        p + k for p in prediction_prefixes(P - 1) for k in OUT_KEYS]


def eval_numbers(config: Dict, weights: Dict, samples: List[Dict],
                 with_loss: bool, device) -> Dict[str, float]:
    """Each sample: {"batch": host batch, "ep": the program's end points
    (host), "counts": what its evaluator added, "match": its matching or
    None}."""
    model = _build(config, weights, device)
    model.eval()
    P = config["model"]["num_decoder_layers"] + 1
    prefixes = prediction_prefixes(P - 1)
    gt_setup = config["data"]["box_stream"] == "gt"
    out = {"kps_gap": 0.0, "out_gap": 0.0, "answer_gap": 0.0,
           "fps_mismatch": 0, "hits_diff": 0.0}
    if with_loss:
        out.update(loss_gap=0.0, match_gap=0.0)
    for s in samples:
        batch, prog = s["batch"], s["ep"]
        with torch.no_grad():
            ep, det = model.encode(_batch_on(batch, MODEL_INPUTS, device))
            out["fps_mismatch"] += _fps_mismatch(prog, ep)
            chosen = torch.as_tensor(prog["query_points_sample_inds"])
            out["kps_gap"] = max(out["kps_gap"], kps_gap(
                ep["seeds_obj_cls_logits"], chosen))
            if chosen.shape[0] != ep["seeds_obj_cls_logits"].shape[0]:
                out["out_gap"] = out["answer_gap"] = math.inf
                out["hits_diff"] = math.inf
                continue
            ep = model.decode(ep, det, chosen.long().to(device))
            # each answer's widest gap: the median answer's fails the
            # control (the widest answer's reads within a factor of two of
            # the control's); the widest answer's fails one wrong answer,
            # such as the last layer's boxes, that the median would pass
            gaps = {k: rel_gap(prog[k], ep[k]) for k in output_keys(P)}
            if max(gaps.values()) >= out["answer_gap"]:
                out["answer_gap_at"] = max(gaps, key=gaps.get)
            out["answer_gap"] = max(out["answer_gap"], max(gaps.values()))
            out["out_gap"] = max(out["out_gap"],
                                 float(np.median(list(gaps.values()))))
            if with_loss:
                ep.update(_batch_on(batch, TARGETS, device))
                B, G = ep["box_label_mask"].shape
                match = s["match"].reshape(P, B, G).to(device)
                costs = costs_by_prefix(ep, P - 1)
                out["match_gap"] = max(out["match_gap"], max(
                    assignment_excess(costs[j], match[j],
                                      ep["box_label_mask"])
                    for j in range(P)))
                value = hungarian_loss(ep, match, P - 1)[0].item()
                out["loss_gap"] = max(out["loss_gap"], abs(
                    float(prog["loss"]) - value) / max(abs(value), 1e-30))
            # the evaluator, judged on the program's own end points
            judged = {k: torch.as_tensor(v).to(device) if isinstance(
                v, torch.Tensor) else v for k, v in prog.items()}
            for k in ("all_bboxes", "all_bbox_label_mask", "center_label",
                      "size_gts", "positive_map", "box_label_mask"):
                judged.setdefault(k, batch[k].to(device))
            for k in ("is_view_dep", "is_hard", "is_unique"):
                judged[k] = batch[k].numpy()
            order = prefixes[-1:] + prefixes[:-1]
            want = gt_counts(judged, order) if gt_setup else \
                topk_counts(judged, order)
            got = s["counts"]
            out["hits_diff"] += sum(abs(got.get(k, math.nan) - v)
                                    for k, v in want.items())
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for every limited number; a number that
    is not finite fails."""
    return {k: {"value": float(numbers[k]), "limit": float(lim)}
            for k, lim in limits.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def seeds_of(trainer_seed: int, steps: int, dp_index: int = 0
             ) -> List[int]:
    """The dropout seeds `Trainer.begin_step` draws for its first steps
    (on a rank of dp index `dp_index`, which it mixes into each draw)."""
    g = torch.Generator().manual_seed(trainer_seed)
    return [(int(torch.randint(0, 2 ** 62, (1,), generator=g))
             + dp_index * 1_000_003) % 2 ** 62 for _ in range(steps)]


__all__ = ["eval_numbers", "judge", "passed", "seeds_of", "train_numbers"]
