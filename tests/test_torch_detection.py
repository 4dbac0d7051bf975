"""The detection evaluation: the port's copies of the JAX package's
`eval/{box_util,nms,metrics,detection}.py`, its `detection_token_map` and
`TrainTester.evaluate_one_epoch_det`, against the JAX package and the
original reference, on the CPU.

- tests/golden/ap_golden.npz (values of running the reference's
  models/ap_helper.py and utils/eval_det.py): the port's parse_predictions
  -> NMS -> APCalculator gives its detection and box counts, and its mAP
  and AR to 1e-6 relative, as tests/test_ap_golden.py holds the JAX
  package;
- the NMS and `eval_det` on seeded boxes with tied scores and IoUs exactly
  at the threshold: equal to the JAX functions on their numpy path (the
  port's only path) in every case, and on their host C++ path
  (`butd_detr_tpu/native.py`) wherever that path agrees with its own
  numpy fallback: the C++ NMS takes tied scores in index order, numpy's
  unstable argsort does not (ROADMAP section 3);
- `detection_token_map` equal to the JAX one for `SimpleTokenizer`;
- one detection epoch of the port's harness beside the JAX harness's on a
  `make_fake_scannet` root with the same weights (`--butd`, as
  tests/test_harness.py's detection test; `--ap_iou_thresholds 0.05
  0.25`, and box heads set so that some boxes overlap objects, so that
  not every AP is 0): the same boxes survive the NMS, and every AP,
  recall, mAP and AR is equal; and two `--dp 2` ranks give the one
  process's numbers.
"""

import os
import os.path as osp

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from butd_detr_tpu import native
from butd_detr_tpu.data import JointGroundingDataset as JDataset
from butd_detr_tpu.data.loader import DataLoader as JDataLoader
from butd_detr_tpu.data.scan import load_scans_parallel as j_load_scans
from butd_detr_tpu.eval import detection as jdetection
from butd_detr_tpu.eval import nms as jnms
from butd_detr_tpu.lang.roberta import RobertaConfig as JRobertaConfig
from butd_detr_tpu.lang.tokenizer import SimpleTokenizer as JTokenizer
from butd_detr_tpu.parallel import make_mesh
from butd_detr_tpu.train import TrainTester as JTrainTester
from butd_detr_tpu.train import harness as j_harness
from butd_detr_tpu.train import detection_token_map as j_detection_token_map
from butd_detr_tpu.train.config import Config as JConfig
from butd_detr_tpu.train.step import (
    INPUT_KEYS as J_INPUT_KEYS,
    TrainState,
    build_model as j_build_model,
    make_eval_step,
)
from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.convert import state_dict_from_jax
from butd_detr_tpu_torch.eval import (
    APCalculator,
    default_parse_config,
    eval_det,
    get_3d_box_batch,
    get_iou_obb,
    nms_2d_faster,
    nms_3d_faster,
    nms_3d_faster_samecls,
    parse_groundtruths,
    parse_predictions,
)
from butd_detr_tpu_torch.lang import SimpleTokenizer
from butd_detr_tpu_torch.train import detection_token_map
from butd_detr_tpu_torch.train import harness as p_harness

import torch_ranks
from test_torch_harness import CFG, NPOINTS, ScanNetTrainTester, \
    _scannet_root
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = osp.join(osp.dirname(osp.abspath(__file__)), "golden",
                   "ap_golden.npz")


@pytest.fixture
def jax_numpy_path(monkeypatch):
    """The JAX package's eval functions on their numpy fallbacks."""
    monkeypatch.setattr(native, "load_native", lambda: None)


def test_golden_ap_of_the_reference():
    g = dict(np.load(FIXTURE, allow_pickle=False))
    ep = {k: v for k, v in g.items() if not k.startswith("golden_")}
    preds = parse_predictions(ep, default_parse_config(dataset_num_class=18),
                              "last_")
    gts = parse_groundtruths(ep)
    np.testing.assert_array_equal([len(p) for p in preds],
                                  g["golden_num_dets"])
    np.testing.assert_array_equal([len(t) for t in gts], g["golden_num_gts"])
    calc = APCalculator(ap_iou_thresh=0.25)
    calc.step(preds, gts)
    m = calc.compute_metrics()
    assert m["mAP"] == pytest.approx(float(g["golden_mAP"]), rel=1e-6)
    assert m["AR"] == pytest.approx(float(g["golden_AR"]), rel=1e-6)


# ------------------------------------------------------------------ NMS

def _nms_boxes(seed, distinct_scores):
    """60 boxes with integer corners (so that many pairs overlap at IoU
    exactly 1/4, 1/7 or 1/2), scores in quarters (tied) or all distinct,
    and 3 classes: [x1, y1, z1, x2, y2, z2, score, class]."""
    rng = np.random.RandomState(seed)
    lo = rng.randint(0, 6, (60, 3)).astype(np.float64)
    hi = lo + rng.randint(1, 4, (60, 3))
    score = (rng.permutation(60) / 60.0 if distinct_scores
             else rng.randint(0, 5, 60) / 4.0)
    cls = rng.randint(0, 3, 60).astype(np.float64)
    return np.concatenate([lo, hi, score[:, None], cls[:, None]], 1)


NMS = {
    "3d": (nms_3d_faster, jnms.nms_3d_faster, lambda b: b[:, :7]),
    "3d_samecls": (nms_3d_faster_samecls, jnms.nms_3d_faster_samecls,
                   lambda b: b),
    "2d": (nms_2d_faster, jnms.nms_2d_faster, lambda b: b[:, [0, 1, 3, 4, 6]]),
}


def _exact_overlaps(b, thresholds):
    """How many box pairs overlap at IoU exactly at a threshold."""
    lo, hi = b[:, :3], b[:, 3:6]
    inter = np.prod(np.clip(np.minimum(hi[:, None], hi[None])
                            - np.maximum(lo[:, None], lo[None]), 0, None), -1)
    vol = np.prod(hi - lo, -1)
    iou = inter / (vol[:, None] + vol[None] - inter)
    return int(np.isin(iou[np.triu_indices(len(b), 1)], thresholds).sum())


@pytest.mark.parametrize("kind", sorted(NMS))
def test_nms_equals_the_jax_numpy_path_with_ties(kind, jax_numpy_path):
    port, jax_fn, cols = NMS[kind]
    exact = 0
    for seed in range(20):
        b = _nms_boxes(seed, distinct_scores=False)
        exact += _exact_overlaps(b, (0.25, 0.5))
        for thr in (0.25, 0.5):
            for old_type in (False, True):
                assert list(port(cols(b), thr, old_type)) == \
                    list(jax_fn(cols(b), thr, old_type)), (seed, thr)
    assert exact > 0


@pytest.mark.parametrize("kind", sorted(NMS))
def test_nms_equals_the_jax_native_path_at_distinct_scores(kind):
    """Distinct scores, IoUs at the threshold: the port equals the JAX
    package's host C++ NMS (f32) too."""
    if native.load_native() is None:
        pytest.skip("the JAX package's host library did not build")
    port, jax_fn, cols = NMS[kind]
    for seed in range(20):
        b = _nms_boxes(seed, distinct_scores=True)
        for thr in (0.25, 0.5):
            assert list(port(cols(b), thr)) == list(jax_fn(cols(b), thr)), \
                (seed, thr)


# --------------------------------------------------------------- eval_det

def _scenes(seed, n_img=4, n_gt=5, n_pred=14):
    """Parsed predictions and ground truths of `n_img` scenes, 3 classes:
    each scene's first ground-truth box (x-extent [lo, lo + 3]) has a
    prediction of x-extent [lo - 1, lo + 1] (IoU exactly 1/4); the rest
    are shifted copies of ground truths and random boxes, scores in
    quarters (tied)."""
    rng = np.random.RandomState(seed)
    pred_all, gt_all = {}, {}
    for im in range(n_img):
        center = rng.randint(1, 6, (n_gt, 3)) + 0.5
        size = rng.randint(1, 4, (n_gt, 3)).astype(np.float64)
        size[0] = 3.0, 1.0, 1.0
        gcls = rng.randint(0, 3, n_gt)
        gt = get_3d_box_batch(size, np.zeros(n_gt), center)
        gt_all[im] = [(int(c), gt[j]) for j, c in enumerate(gcls)]
        src = rng.randint(0, n_gt, n_pred)
        pc = center[src] + rng.randint(-1, 2, (n_pred, 3)) * 0.5
        ps = size[src].copy()
        pc[0], ps[0] = center[0] - [1.5, 0, 0], (2.0, 1.0, 1.0)
        pcls = np.where(rng.rand(n_pred) < 0.7, gcls[src],
                        rng.randint(0, 3, n_pred))
        pcls[0] = gcls[0]
        score = rng.randint(0, 4, n_pred) / 4.0
        corners = get_3d_box_batch(ps, np.zeros(n_pred), pc)
        pred_all[im] = [(int(c), corners[j], float(score[j]))
                        for j, c in enumerate(pcls)]
    return pred_all, gt_all


def _assert_same_eval_det(got, want):
    rec, prec, ap = got
    assert set(ap) == set(want[2])
    for c in want[2]:
        assert ap[c] == want[2][c], c
        np.testing.assert_array_equal(rec[c], want[0][c])
        np.testing.assert_array_equal(prec[c], want[1][c])


@pytest.mark.parametrize("path", ["numpy", "native"])
def test_eval_det_equals_the_jax_function(path, monkeypatch):
    if path == "numpy":
        monkeypatch.setattr(native, "load_native", lambda: None)
    elif native.load_native() is None:
        pytest.skip("the JAX package's host library did not build")
    for seed in range(12):
        pred_all, gt_all = _scenes(seed)
        for thr in (0.25, 0.5):
            _assert_same_eval_det(eval_det(pred_all, gt_all, thr),
                                  jdetection.eval_det(pred_all, gt_all, thr))
        # the planted pair lies at IoU 1/4 exactly: a false positive at
        # 0.25 (a match needs IoU > threshold), a true one below it
        assert get_iou_obb(pred_all[0][0][1], gt_all[0][0][1]) == 0.25
        one = ({0: pred_all[0][:1]}, {0: gt_all[0][:1]})
        assert eval_det(*one, 0.25)[2][gt_all[0][0][0]] == 0.0
        assert eval_det(*one, 0.2)[2][gt_all[0][0][0]] == pytest.approx(1.0)


def test_detection_token_map_equals_the_jax_one():
    for max_len in (64, 256):
        got = detection_token_map(SimpleTokenizer(max_len=max_len))
        want = j_detection_token_map(JTokenizer(max_len=max_len))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    wordidx, tokenidx = got
    assert set(wordidx) == set(range(19))
    assert (np.diff(tokenidx) > 0).all()


# ------------------------------------------------------ the harness epoch

def _plausible_boxes(params):
    """Boxes of side 0.8 centred near the query points, which lie on the
    scenes' objects: the last layer of every size and centre head scaled
    by 0.01, the size's bias 0.8. Seeded random weights otherwise give
    boxes that overlap no object, and every AP would be 0."""
    def fix(path, x):
        names = [getattr(p, "key", None) for p in path]
        for head, bias in (("size_pred_head", 0.8),
                           ("center_residual_head", 0.0)):
            if head in names and x.shape[-1] == 3:
                return np.full_like(x, bias) if names[-1] == "bias" \
                    else x * 0.01
        return x
    return jax.tree_util.tree_map_with_path(fix, params)


@pytest.fixture(scope="module")
def detection_epoch(tmp_path_factory):
    """The 5 val scenes of a `make_fake_scannet` root (a batch of 4 and a
    padded tail of 1) through the JAX harness's and the port's
    `evaluate_one_epoch_det`, with one set of weights, under `--butd`."""
    tmp = tmp_path_factory.mktemp("det")
    root = _scannet_root(tmp)
    kw = dict(CFG, butd_cls=False, butd=True, dataset=["scannet"],
              test_dataset="scannet", data_root=root,
              ap_iou_thresholds=(0.05, 0.25))
    jcfg = JConfig(**dict(kw, log_dir=str(tmp / "jlog")))
    meta = os.path.join(root, "meta_data")
    with open(os.path.join(meta, "scannetv2_val.txt")) as f:
        scan_ids = f.read().split()
    test_set = JDataset(
        dataset_dict={"scannet": 1}, test_dataset="scannet", split="val",
        data_path=root, use_color=True, butd=True, max_text_len=12,
        max_num_obj=8, max_det_boxes=8,
        tokenizer=JTokenizer(vocab_size=1024, max_len=12),
        scans=j_load_scans(scan_ids, os.path.join(root, "scans"), meta,
                           num_workers=1, keep_points=1024))
    jloader = JDataLoader(test_set, batch_size=4, shuffle=False,
                          drop_last=False, seed=jcfg.rng_seed)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    roberta = dict(ScanNetTrainTester.roberta)
    jm = j_build_model(jcfg, roberta_config=JRobertaConfig(**roberta),
                       backbone_npoints=NPOINTS)
    first = next(iter(jloader))
    variables = jax.jit(jm.init)(
        jax.random.PRNGKey(0),
        {k: jnp.asarray(first[k]) for k in J_INPUT_KEYS})
    variables = dict(variables,
                     params=_plausible_boxes(to_np(variables["params"])))
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=None)
    eval_step = jax.jit(make_eval_step(jm, jcfg, with_loss=False))
    parsed = {"want": [], "got": []}

    def recording(fn, into):
        def parse(ep, cfg, prefix):
            preds = fn(ep, cfg, prefix)
            into.append((ep[f"{prefix}pred_mask"].copy(), preds))
            return preds
        return parse

    tester = ScanNetTrainTester(Config(**dict(kw, log_dir=str(tmp / "log"))),
                                device="cpu")
    tester.state_dict = state_dict_from_jax(to_np(variables["params"]),
                                            to_np(variables["batch_stats"]))
    lines = []
    tester.logger = type("L", (), {"info": staticmethod(lines.append)})
    _, test_loader = tester.get_loaders()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_harness, "parse_predictions",
                   recording(j_harness.parse_predictions, parsed["want"]))
        mp.setattr(p_harness, "parse_predictions",
                   recording(p_harness.parse_predictions, parsed["got"]))
        want = JTrainTester(jcfg).evaluate_one_epoch_det(
            1, jloader, eval_step, state, make_mesh(n_devices=1))
        got = tester.evaluate_one_epoch(1, test_loader,
                                        tester.get_trainer(1))
    return dict(got=got, want=want, parsed=parsed, lines=lines,
                n=len(test_set), thresholds=kw["ap_iou_thresholds"],
                kw=kw, roberta=roberta, state_dict=tester.state_dict,
                tmp=tmp)


def test_detection_epoch_equals_the_jax_harness(detection_epoch):
    got, want = detection_epoch["got"], detection_epoch["want"]
    assert detection_epoch["n"] == 5
    assert list(got) == list(want) == list(detection_epoch["thresholds"])
    for t in want:
        assert set(got[t]) == set(want[t])
        assert any(k.endswith("Average Precision") for k in want[t])
        for k, w in want[t].items():
            assert got[t][k] == w, (t, k, got[t][k], w)
        assert 0.0 <= got[t]["mAP"] <= 1.0 and 0.0 <= got[t]["AR"] <= 1.0
    assert got[0.05]["mAP"] > 0.0


def test_two_dp_ranks_give_the_one_process_detection_metrics(
        detection_epoch):
    """`--dp 2`: each rank parses its rows of every batch (the tail's 1
    real row on rank 0, none on rank 1) and the first process steps the AP
    calculators through every shard's boxes in one process's order."""
    d = detection_epoch
    cfg = dict(d["kw"], dp=2, log_dir=str(d["tmp"] / "dp_log"))
    got, other = torch_ranks.run_ranks(
        torch_ranks.detection_world, 2, cfg, d["roberta"], NPOINTS,
        {k: torch.as_tensor(v) for k, v in d["state_dict"].items()})
    assert other is None
    want = d["got"]
    assert list(got) == list(want)
    for t in want:
        assert got[t] == pytest.approx(want[t], rel=1e-6, abs=1e-9), t


def test_detection_epoch_parses_the_jax_harness_predictions(
        detection_epoch):
    """Per batch, the same boxes survive the NMS, and every parsed
    detection has the JAX harness's class, and its corners and score
    within 1e-5: the two models' f32 end points differ by a few roundings
    (observed 2.4e-7)."""
    got, want = detection_epoch["parsed"]["got"], \
        detection_epoch["parsed"]["want"]
    assert len(got) == len(want) == 2
    assert [len(m) for m, _ in got] == [4, 1]  # the tail's valid row only
    worst = 0.0
    for (gmask, gpreds), (wmask, wpreds) in zip(got, want):
        np.testing.assert_array_equal(gmask, wmask)
        assert [len(p) for p in gpreds] == [len(p) for p in wpreds]
        for gp, wp in zip(gpreds, wpreds):
            assert [c for c, _, _ in gp] == [c for c, _, _ in wp]
            for (_, gc, gs), (_, wc, ws) in zip(gp, wp):
                worst = max(worst, float(np.abs(gc - wc).max()),
                            abs(gs - ws))
    assert worst <= 1e-5


def test_detection_epoch_logs_its_stats_and_metrics(detection_epoch):
    import json

    lines = detection_epoch["lines"]
    stats = [json.loads(m.split("epoch stats ", 1)[1]) for m in lines
             if m.startswith("epoch stats ")]
    assert len(stats) == 1
    assert stats[0]["phase"] == "eval" and stats[0]["scenes"] == 5
    assert stats[0]["batches"] == 2
    assert stats[0]["detection_seconds"] > 0.0
    assert stats[0]["detection_copy_seconds"] >= 0.0
    for t in detection_epoch["thresholds"]:
        assert f"=====> last_ IOU THRESH: {t} <=====" in lines
    assert sum(m.startswith("mAP ") for m in lines) == \
        len(detection_epoch["thresholds"])
    # --butd evaluates with the loss, as the JAX harness's main does
    assert any(m.startswith("Eval: [2/2]") and " loss " in f" {m} "
               for m in lines)
