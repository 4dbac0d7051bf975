"""The Hungarian loss's one stacked pass over the prefixes against the same
set losses called once a prefix (`set_criterion_losses`, the P = 1 case),
on the CPU.

`compute_hungarian_loss` matches every prefix in one call and computes
each set loss once over (P, B, ...) predictions, the scenes' targets
broadcast over the prefix axis. The reference here runs the stacked
call's own assignment through `set_criterion_losses` prefix by prefix and
sums as the per-prefix loss did. Held, for P = 3 (the study's 2-layer
setups) and P = 7 (6 decoder layers), soft-token and label costs, and the
contrastive loss off, on with pad tokens masked and on with the
reference's unmasked normalizer:
- every per-prefix end point, the four totals, the kps loss and the loss
  to rtol 1e-5 in f32;
- the gradient of every prediction and of `proj_tokens` to rtol 1e-5
  (atol 1e-5 of the leaf's largest gradient, for entries that cancel to
  near zero);
- one matching call and one matched-box gather for all prefixes.
The bf16 contrastive branch (bf16 predictions and tokens, as under
`--use_bf16`) is held to test_torch_bf16_model.py's 1 % on the losses.
"""

import numpy as np
import pytest
import torch

from butd_detr_tpu_torch.losses import (
    CriterionConfig,
    compute_hungarian_loss,
    compute_points_obj_cls_loss_hard_topk,
    set_criterion_losses,
)
from butd_detr_tpu_torch.losses import criterion
from butd_detr_tpu_torch.models.bdetr import prediction_prefixes

B, Q, G, L, C, K, N = 3, 24, 7, 14, 256, 40, 200
PRED_KEYS = ("center", "pred_size", "sem_cls_scores", "proj_queries")


def _end_points(layers, seed, dtype=torch.float32):
    """Random end points of `layers` decoder layers; predictions and
    `proj_tokens` in `dtype`, each a leaf that needs a gradient."""
    g = torch.Generator().manual_seed(seed)
    n_valid = torch.tensor([[4], [7], [1]])
    mask = (torch.arange(G)[None] < n_valid).float()
    text_mask = (torch.arange(L)[None] < torch.tensor([[9], [14], [6]]))
    pmap = torch.zeros(B, G, C)
    for b in range(B):
        for t in range(G):
            s = int(torch.randint(0, 12, (1,), generator=g))
            pmap[b, t, s:s + 2] = 0.5
    unit = lambda *s: torch.nn.functional.normalize(
        torch.randn(*s, generator=g), dim=-1)
    ep = {
        "center_label": torch.rand(B, G, 3, generator=g) * 3,
        "size_gts": torch.rand(B, G, 3, generator=g) * 0.5 + 0.2,
        "sem_cls_label": torch.randint(0, C, (B, G), generator=g),
        "box_label_mask": mask,
        "positive_map": pmap * mask[..., None],
        "text_mask": text_mask.int(),
        "point_instance_label": torch.randint(-1, G, (B, N), generator=g),
        "seed_inds": torch.randint(0, N, (B, K), generator=g),
        "seed_xyz": torch.rand(B, K, 3, generator=g) * 3,
        "seeds_obj_cls_logits": torch.randn(B, K, generator=g),
        "proj_tokens": unit(B, L, 64).to(dtype).requires_grad_(),
    }
    for p in prediction_prefixes(layers):
        preds = {"center": torch.rand(B, Q, 3, generator=g) * 3,
                 "pred_size": torch.rand(B, Q, 3, generator=g) * 0.6 + 0.1,
                 "sem_cls_scores": 5 * torch.randn(B, Q, C, generator=g),
                 "proj_queries": unit(B, Q, 64)}
        for k, v in preds.items():
            ep[p + k] = v.to(dtype).requires_grad_()
    return ep


def _leaves(ep):
    return {k: v for k, v in ep.items() if v.requires_grad}


def _stacked(ep, layers, cfg, monkeypatch):
    """compute_hungarian_loss, counting its matching calls and matched-box
    gathers through the criterion module's global names."""
    calls = {"match": [], "gather": 0}
    match, gather = criterion.hungarian_match, criterion.gather_points

    def on_match(*args, **kwargs):
        calls["match"].append(match(*args, **kwargs))
        return calls["match"][-1]

    def on_gather(*args):
        calls["gather"] += 1
        return gather(*args)

    monkeypatch.setattr(criterion, "hungarian_match", on_match)
    monkeypatch.setattr(criterion, "gather_points", on_gather)
    loss, out = compute_hungarian_loss(dict(ep), layers, cfg, 4)
    monkeypatch.undo()
    return loss, out, calls


def _per_prefix(ep, layers, cfg, assignment_all):
    """The set losses of each prefix alone on the stacked call's
    assignment, summed prefix by prefix."""
    targets = {
        "boxes": torch.cat([ep["center_label"], ep["size_gts"]], dim=-1),
        "positive_map": ep["positive_map"],
        "box_label_mask": ep["box_label_mask"],
        "text_mask": ep["text_mask"],
        "labels": ep["sem_cls_label"],
    }
    num_boxes = ep["box_label_mask"].sum().clamp_min(1.0)
    out, totals = {}, {}
    for pi, p in enumerate(prediction_prefixes(layers)):
        outputs = {"pred_logits": ep[f"{p}sem_cls_scores"],
                   "pred_boxes": torch.cat([ep[f"{p}center"],
                                            ep[f"{p}pred_size"]], dim=-1),
                   "assignment": assignment_all[pi],
                   "proj_queries": ep[f"{p}proj_queries"],
                   "proj_tokens": ep["proj_tokens"]}
        losses, _ = set_criterion_losses(outputs, targets, num_boxes, cfg)
        for name, v in losses.items():
            out[f"{p}_{name}"] = v
            totals[name] = totals.get(name, 0.0) + v
    kps = compute_points_obj_cls_loss_hard_topk(ep, 4)
    loss = 8 * kps + 1.0 / (layers + 1) * (
        totals["loss_ce"] + 5 * totals["loss_bbox"] + totals["loss_giou"]
        + totals.get("loss_contrastive_align", 0.0))
    out.update(totals, query_points_generation_loss=kps, loss=loss)
    return loss, out


def _compare(ep, layers, cfg, monkeypatch, rtol, grad_atol):
    loss, got, calls = _stacked(ep, layers, cfg, monkeypatch)
    assert len(calls["match"]) == 1 and calls["gather"] == 1
    assignment_all = calls["match"][0].reshape(layers + 1, B, G)
    want_loss, want = _per_prefix(ep, layers, cfg, assignment_all)
    contrastive = cfg.use_contrastive_align
    assert len([k for k in want if "loss" in k]) == (
        5 + (4 if contrastive else 3) * (layers + 1) + contrastive)
    value = lambda x: float(torch.as_tensor(x).detach())
    for k, w in want.items():
        np.testing.assert_allclose(value(got[k]), value(w), rtol=rtol,
                                   err_msg=k)
    if not contrastive:
        assert got["loss_contrastive_align"] == 0.0
        assert not any(k.endswith("_loss_contrastive_align") for k in got)
    leaves = _leaves(ep)
    names = [k for k in leaves
             if contrastive or not k.endswith("proj_queries")
             and k != "proj_tokens"]
    assert len(names) == (len(PRED_KEYS) if contrastive else 3) * (
        layers + 1) + contrastive
    got_grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    want_grads = torch.autograd.grad(want_loss, [leaves[k] for k in names])
    for k, g, w in zip(names, got_grads, want_grads):
        g, w = g.float().numpy(), w.float().numpy()
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=grad_atol * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("contrastive", ["off", "masked", "unmasked"])
@pytest.mark.parametrize("soft_token", [True, False],
                         ids=["soft_token", "labels"])
@pytest.mark.parametrize("layers", [2, 6], ids=["P3", "P7"])
def test_stacked_pass_equals_one_prefix_at_a_time(layers, soft_token,
                                                  contrastive, monkeypatch):
    cfg = CriterionConfig(use_soft_token=soft_token,
                          use_contrastive_align=contrastive != "off",
                          mask_pad_tokens=contrastive != "unmasked")
    _compare(_end_points(layers, seed=layers * 10 + soft_token), layers, cfg,
             monkeypatch, rtol=1e-5, grad_atol=1e-5)


@pytest.mark.parametrize("layers", [2, 6], ids=["P3", "P7"])
def test_stacked_pass_in_bf16_equals_one_prefix_at_a_time(layers,
                                                          monkeypatch):
    """bf16 predictions and tokens: the contrastive logits divide by a
    bf16 temperature, and the losses run in f32 from there."""
    _compare(_end_points(layers, seed=7, dtype=torch.bfloat16), layers,
             CriterionConfig(), monkeypatch, rtol=1e-2, grad_atol=1e-2)


def test_set_criterion_losses_matches_itself_and_returns_scalars():
    """Without a ready assignment, `set_criterion_losses` matches through
    the module's `hungarian_match`, and returns one scalar a loss."""
    ep = _end_points(2, seed=3)
    targets = {
        "boxes": torch.cat([ep["center_label"], ep["size_gts"]], dim=-1),
        "positive_map": ep["positive_map"],
        "box_label_mask": ep["box_label_mask"],
        "text_mask": ep["text_mask"],
    }
    outputs = {"pred_logits": ep["last_sem_cls_scores"],
               "pred_boxes": torch.cat([ep["last_center"],
                                        ep["last_pred_size"]], dim=-1),
               "proj_queries": ep["last_proj_queries"],
               "proj_tokens": ep["proj_tokens"]}
    losses, assignment = set_criterion_losses(
        outputs, targets, torch.tensor(12.0), CriterionConfig())
    assert assignment.shape == (B, G) and assignment.dtype == torch.int64
    assert set(losses) == {"loss_ce", "loss_bbox", "loss_giou",
                           "loss_contrastive_align"}
    assert all(v.shape == () and torch.isfinite(v) for v in losses.values())
    again, _ = set_criterion_losses(dict(outputs, assignment=assignment),
                                    targets, torch.tensor(12.0),
                                    CriterionConfig())
    for k, v in losses.items():
        assert torch.equal(v, again[k]), k
