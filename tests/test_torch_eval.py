"""The grounding evaluators of the port against the JAX package's on the
same numpy end points (every counter equal), the scorers and hit tensors
one by one, and `GroundingEvaluator` against the counts the original
reference produced (tests/golden/eval_golden.npz), as
tests/test_eval_golden.py holds the JAX evaluator.

Counters are sums of 0/1 hits and compare exactly; scores to 1e-6 + 2e-5
relative (the contrastive logits, a 64-term f32 dot product over 0.07, reach
tens, and the softmax passes their last-bit differences on as relative
error).
"""

import os.path as osp

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_ranks
from butd_detr_tpu.eval import grounding as jg
from butd_detr_tpu_torch.eval import (
    BREAKDOWN_FIELDS,
    GroundingEvaluator,
    GroundingGTEvaluator,
    contrast_scores,
    grounding_batch_hits,
    gt_grounding_batch_hits,
    span_scores,
    topk_box_hits,
)
from butd_detr_tpu_torch.utils import (
    allreduce_dict,
    is_main_process,
    process_count,
    process_index,
)

FIXTURE = osp.join(osp.dirname(osp.abspath(__file__)), "golden",
                   "eval_golden.npz")
PREFIXES = ["last_", "proposal_", "0head_"]


def _end_points(seed, B=6, Q=24, K=5, M=9, T=20, width=256):
    """Random end points whose predictions sit on or near scene boxes, so
    that hits and misses both occur; some samples have no root object."""
    rng = np.random.RandomState(seed)
    all_boxes = np.concatenate([rng.rand(B, M, 3) * 4,
                                rng.rand(B, M, 3) * 0.8 + 0.3], -1)
    all_mask = np.arange(M)[None] < rng.randint(K, M + 1, (B, 1))
    ep = {
        "all_bboxes": all_boxes.astype(np.float32),
        "all_bbox_label_mask": all_mask,
        "center_label": all_boxes[:, :K, :3].astype(np.float32),
        "size_gts": all_boxes[:, :K, 3:].astype(np.float32),
        "box_label_mask": (np.arange(K)[None]
                           < rng.randint(0, K + 1, (B, 1))).astype(np.float32),
        "proj_tokens": rng.randn(B, T, 64).astype(np.float32) * 0.3,
        "is_view_dep": rng.rand(B) < 0.5,
        "is_hard": rng.rand(B) < 0.5,
        "is_unique": rng.rand(B) < 0.5,
    }
    pmap = np.zeros((B, K, width), np.float32)
    for b in range(B):
        for k in range(K):
            s = rng.randint(1, T - 2)
            pmap[b, k, s:s + 2] = 0.5
    ep["positive_map"] = pmap
    for p in PREFIXES:
        which = rng.randint(0, M, (B, Q))
        near = np.take_along_axis(all_boxes, which[..., None], 1)
        jitter = rng.randn(B, Q, 6) * rng.choice([0.0, 0.05, 0.6], (B, Q, 1))
        pred = near + jitter
        ep[p + "center"] = pred[..., :3].astype(np.float32)
        ep[p + "pred_size"] = np.abs(pred[..., 3:]).astype(np.float32)
        ep[p + "sem_cls_scores"] = (rng.randn(B, Q, T) * 2).astype(np.float32)
        ep[p + "proj_queries"] = rng.randn(B, Q, 64).astype(np.float32) * 0.3
    return ep


def _torch(ep):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in ep.items()}


def _jax(ep):
    return {k: jnp.asarray(v) for k, v in ep.items()}


@pytest.mark.parametrize("name", ["span_scores", "contrast_scores"])
def test_scorers_match_jax(name):
    ep = _end_points(0)
    got = {"span_scores": span_scores,
           "contrast_scores": contrast_scores}[name](_torch(ep), "last_", 256)
    want = getattr(jg, name)(_jax(ep), "last_", 256)
    assert got.shape == (6, 24, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=2e-5)
    assert float(got[..., 20:].abs().max()) == 0.0  # zero-padded to 256


def test_topk_box_hits_match_jax_and_break_ties_to_the_lower_index():
    ep = _end_points(1)
    rng = np.random.RandomState(5)
    # scores with exact ties: a few distinct values only
    sem = rng.choice([0.0, 0.25, 0.5], (6, 24, 256)).astype(np.float32)
    pred = np.concatenate([ep["last_center"], ep["last_pred_size"]], -1)
    gt = np.concatenate([ep["center_label"], ep["size_gts"]], -1)
    pmap = (ep["positive_map"] > 0).astype(np.float32)
    args = (sem, pred, pmap, gt)
    got = topk_box_hits(*map(torch.from_numpy, args), (0.25, 0.5), (1, 5, 10))
    want = jg.topk_box_hits(*map(jnp.asarray, args), (0.25, 0.5), (1, 5, 10))
    assert got.shape == (6, 5, 2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got.mean()) < 1  # hits and misses both occur


@pytest.mark.parametrize("with_contrast", [True, False])
def test_batch_hit_tensors_match_jax(with_contrast):
    ep = _end_points(2)
    got = grounding_batch_hits(_torch(ep), PREFIXES, only_root=False,
                               with_contrast=with_contrast)
    want = jg.grounding_batch_hits(_jax(ep), PREFIXES, only_root=False,
                                   with_contrast=with_contrast)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    got = gt_grounding_batch_hits(_torch(ep), PREFIXES,
                                  with_contrast=with_contrast)
    want = jg.gt_grounding_batch_hits(_jax(ep), PREFIXES,
                                      with_contrast=with_contrast)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def _assert_same_counters(got, want):
    assert set(got.dets) == set(want.dets) and set(got.gts) == set(want.gts)
    for k in want.dets:
        assert got.dets[k] == want.dets[k], k
        assert got.gts[k] == want.gts[k], k


@pytest.mark.parametrize("only_root", [True, False])
def test_grounding_evaluator_counters_equal_the_jax_evaluators(only_root):
    lines_got, lines_want = [], []
    log_got = type("L", (), {"info": staticmethod(lines_got.append)})
    log_want = type("L", (), {"info": staticmethod(lines_want.append)})
    got = GroundingEvaluator(only_root=only_root, prefixes=PREFIXES,
                             logger=log_got)
    want = jg.GroundingEvaluator(only_root=only_root, prefixes=PREFIXES,
                                 logger=log_want)
    for seed in (3, 4, 5):
        ep = _end_points(seed)
        got.evaluate(_torch(ep) if seed != 4 else ep)  # tensors or numpy
        want.evaluate(ep)
    _assert_same_counters(got, want)
    assert got.dets[("last_", 0.25, 10, "bbf")] > 0
    assert got.accuracy("last_", 0.25, 5) == want.accuracy("last_", 0.25, 5)
    got.synchronize_between_processes()
    _assert_same_counters(got, want)  # one process: unchanged
    got.print_stats()
    want.print_stats()
    assert lines_got == lines_want and "Analysis" in lines_got
    got.reset()
    assert all(v == 0.0 for v in got.dets.values())


@pytest.mark.parametrize("with_contrast", [True, False])
def test_gt_evaluator_counters_equal_the_jax_evaluators(with_contrast):
    lines_got, lines_want = [], []
    log_got = type("L", (), {"info": staticmethod(lines_got.append)})
    log_want = type("L", (), {"info": staticmethod(lines_want.append)})
    got = GroundingGTEvaluator(prefixes=PREFIXES, logger=log_got,
                               with_contrast=with_contrast)
    want = jg.GroundingGTEvaluator(prefixes=PREFIXES, logger=log_want,
                                   with_contrast=with_contrast)
    for seed in (6, 7, 8):
        ep = _end_points(seed)
        got.evaluate(_torch(ep))
        want.evaluate(ep)
    _assert_same_counters(got, want)
    hit = got.dets[("last_", "bbs")]
    assert 0 < hit < got.gts[("last_", "bbs")]  # hits and misses both occur
    assert got.accuracy("proposal_", "bbs") == want.accuracy("proposal_",
                                                             "bbs")
    got.print_stats()
    want.print_stats()
    assert lines_got == lines_want
    assert ("bbf" in got.modes) == with_contrast
    assert (got.gts["easy"] > 1e-10) == with_contrast  # breakdown needs bbf


def test_grounding_evaluator_matches_the_reference_counts():
    g = dict(np.load(FIXTURE, allow_pickle=False))
    ep = {k: v for k, v in g.items() if not k.startswith(("det__", "gt__"))}
    ev = GroundingEvaluator(only_root=True, thresholds=(0.25, 0.5),
                            topks=(1, 5, 10), prefixes=["proposal_", "last_"])
    ev.evaluate(ep)
    for p in ("proposal_", "last_"):
        for t in (0.25, 0.5):
            for k in (1, 5, 10):
                for m in ("bbs", "bbf"):
                    want = float(g[f"det__{p}__{t}__{k}__{m}"])
                    assert ev.dets[(p, t, k, m)] == pytest.approx(want), \
                        (p, t, k, m)
    for f in BREAKDOWN_FIELDS:
        assert ev.dets[f] == pytest.approx(float(g[f"det__{f}"])), f
        assert ev.gts[f] == pytest.approx(float(g[f"gt__{f}"])), f


def test_one_process_helpers_and_the_merge_across_two_ranks():
    assert process_count() == 1 and process_index() == 0
    assert is_main_process()
    d = {("last_", "bbs"): 3.0, "easy": 1e-14}
    out = allreduce_dict(d)
    assert out == d and out is not d
    # the JAX package's test_allreduce_dict_allgather_branch counters, the
    # keys in another order on each rank
    d0 = {"acc_last_0.25": 3.0, "gt_count": 7, "acc_last_0.5": 1.0}
    d1 = {"acc_last_0.5": 2.0, "gt_count": 5, "acc_last_0.25": 4.0}
    ranks = torch_ranks.run_ranks(torch_ranks.merge_counters, 2, [d0, d1])
    for rank, got in enumerate(ranks):
        assert got["merged"] == {"acc_last_0.25": 7.0, "gt_count": 12.0,
                                 "acc_last_0.5": 3.0}
        assert (got["count"], got["index"], got["main"]) == (
            2, rank, rank == 0)