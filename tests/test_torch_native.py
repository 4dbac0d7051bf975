"""The port's host C++ runtime (`butd_detr_tpu_torch/native.py`, built from
`butd_detr_tpu_torch/csrc/butd_native.cpp`) on the CPU:

(a) the library builds from the port's source into `_build/`, and a fresh
    process that reads a PLY, augments a cloud, runs the NMS and the VOC
    matcher maps the port's `.so` and never the JAX package's
    `csrc/libbutd_native.so`;
(b) each wrapper equals `butd_detr_tpu.native`'s on the same seeded
    inputs: the PLY reader (binary little-endian with and without a label
    column; ascii, which both refuse), the NMS (2D, 3D, same-class,
    `old_type`, on 20 sets of tied scores with IoUs exactly at the
    threshold), the VOC matcher's tp and fp, `points_in_boxes` and the
    fused augmentation, bit for bit;
(c) each port caller against its plain version: `read_ply` against the
    Python parser, `augment_pointcloud` within 1e-6 of each array's
    largest magnitude, the NMS and `eval_det` equal at distinct scores;
(d) a build with `CXX=/bin/false` raises with the compiler's exit, and so
    does every caller: there is no fallback to numpy;
(e) `scripts/train_split_eval_torch.py` on a tiny 2-epoch port study
    (`--tiny --device cpu`): one row per checkpoint, each equal to the
    study's own evaluation of that epoch (its `history.jsonl`) and to
    `TrainTester.evaluate_one_epoch` of that checkpoint on the trainval
    root, built here apart from the script.
"""

import dataclasses
import importlib.util
import json
import os
import os.path as osp
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from butd_detr_tpu import native as jnative
from butd_detr_tpu.data.augment import _rot
from butd_detr_tpu_torch import native
from butd_detr_tpu_torch.data import augment_pointcloud, read_ply
from butd_detr_tpu_torch.data.scan import _read_ply_py
from butd_detr_tpu_torch.data.synthetic import _write_ply
from butd_detr_tpu_torch.eval import (
    eval_det,
    get_3d_box_batch,
    nms_2d_faster,
    nms_3d_faster,
    nms_3d_faster_samecls,
)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    """The JAX package's host library, which the comparisons need."""
    if jnative.load_native() is None:
        pytest.skip("the JAX package's host library did not build")


# ------------------------------------------------------------ (a) build

def test_the_ports_library_is_mapped_and_the_jax_one_never(tmp_path):
    path = str(tmp_path / "c.ply")
    code = textwrap.dedent(f"""
        import numpy as np
        from butd_detr_tpu_torch import native
        from butd_detr_tpu_torch.data import augment_pointcloud, read_ply
        from butd_detr_tpu_torch.data.synthetic import _write_ply
        from butd_detr_tpu_torch.eval import eval_det, nms_3d_faster
        rng = np.random.RandomState(0)
        pc = rng.rand(100, 3).astype(np.float32)
        _write_ply({path!r}, pc, color=rng.randint(0, 255, (100, 3)))
        read_ply({path!r})
        augment_pointcloud(pc, None, True, rng)
        nms_3d_faster(np.hstack([pc[:, :3], pc[:, :3] + 1, pc[:, :1]]), 0.25)
        from butd_detr_tpu_torch.eval import get_3d_box_batch
        box = get_3d_box_batch(np.ones((1, 3)), np.zeros(1),
                               np.zeros((1, 3)))[0]
        eval_det({{0: [(1, box, 0.5)]}}, {{0: [(1, box)]}})
        print(native.library_path())
        print(sorted(k for k, v in native.CALLS.items() if v))
        with open("/proc/self/maps") as f:
            print(sorted({{line.split()[-1] for line in f
                          if "butd_native" in line}}))
        """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lib, calls, mapped = out.stdout.strip().splitlines()
    assert lib == str(native.library_path())
    assert osp.dirname(lib) == osp.join(ROOT, "butd_detr_tpu_torch",
                                        "_build")
    assert osp.basename(lib).startswith("butd_native-") and osp.isfile(lib)
    assert calls == str(["augment_fused", "greedy_nms", "ply_read_vertices",
                         "voc_match"])
    assert mapped == str([lib])
    assert "csrc/libbutd_native" not in out.stdout


def test_the_build_uses_the_jax_makefiles_flags():
    with open(osp.join(ROOT, "csrc", "Makefile")) as f:
        flags = next(line for line in f if line.startswith("CXXFLAGS"))
    assert flags.split("?=", 1)[1].split() == native.CXXFLAGS
    assert native.SOURCE == native.library_path().parents[1] / "csrc" / \
        "butd_native.cpp"


# ------------------------------------------------- (b) against the JAX

@pytest.mark.parametrize("kind", ["cloud", "labels", "ascii"])
def test_ply_reader_equals_the_jax_one(tmp_path, kind):
    rng = np.random.RandomState(5)
    pc = (rng.randn(3000, 3) * 3).astype(np.float32)
    path = str(tmp_path / "s.ply")
    if kind == "ascii":
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\nelement vertex 3\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "end_header\n")
            for p in pc[:3]:
                f.write(" ".join(map(repr, p.tolist())) + "\n")
    elif kind == "cloud":
        _write_ply(path, pc, color=rng.randint(0, 256, (3000, 3)))
    else:
        _write_ply(path, pc, label=rng.randint(0, 40, 3000))
    got, want = (native.ply_read_vertices_native(path),
                 jnative.ply_read_vertices_native(path))
    if kind == "ascii":
        assert got is None and want is None
    else:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[0], pc)
    # (c) the port's reader against its Python parser
    mine, plain = read_ply(path), _read_ply_py(path)
    assert set(mine) <= set(plain) and {"x", "y", "z"} <= set(mine)
    for k in mine:
        np.testing.assert_array_equal(mine[k], plain[k], err_msg=k)
    assert ("label" in mine) == (kind == "labels")


def _nms_boxes(seed, distinct_scores):
    """ROADMAP section 3's protocol: 60 boxes with integer corners (many
    pairs at IoU exactly 1/4, 1/7 or 1/2), scores in quarters (tied) or
    all distinct, 3 classes: [x1, y1, z1, x2, y2, z2, score, class]."""
    rng = np.random.RandomState(seed)
    lo = rng.randint(0, 6, (60, 3)).astype(np.float64)
    hi = lo + rng.randint(1, 4, (60, 3))
    score = (rng.permutation(60) / 60.0 if distinct_scores
             else rng.randint(0, 5, 60) / 4.0)
    cls = rng.randint(0, 3, 60).astype(np.float64)
    return np.concatenate([lo, hi, score[:, None], cls[:, None]], 1)


# (mins, maxs, scores, classes) of a box set, and the port's caller
NMS = {
    "2d": (lambda b: (b[:, :2], b[:, 3:5], b[:, 6], None),
           lambda b, *a, **k: nms_2d_faster(b[:, [0, 1, 3, 4, 6]], *a, **k)),
    "3d": (lambda b: (b[:, :3], b[:, 3:6], b[:, 6], None),
           lambda b, *a, **k: nms_3d_faster(b[:, :7], *a, **k)),
    "3d_samecls": (lambda b: (b[:, :3], b[:, 3:6], b[:, 6], b[:, 7]),
                   nms_3d_faster_samecls),
}


@pytest.mark.parametrize("old_type", [False, True])
@pytest.mark.parametrize("kind", sorted(NMS))
def test_nms_equals_the_jax_one_at_tied_scores(kind, old_type):
    split, _ = NMS[kind]
    differs_from_numpy = 0
    for seed in range(20):
        b = _nms_boxes(seed, distinct_scores=False)
        for thr in (0.25, 0.5):
            mins, maxs, scores, classes = split(b)
            got = native.greedy_nms_native(mins, maxs, scores, thr,
                                           old_type, classes)
            assert got == jnative.greedy_nms_native(
                mins, maxs, scores, thr, old_type, classes), (seed, thr)
            differs_from_numpy += got != NMS[kind][1](b, thr, old_type,
                                                      plain=True)
    assert differs_from_numpy > 0  # the ties' order is what differs


@pytest.mark.parametrize("kind", sorted(NMS))
def test_nms_equals_its_plain_version_at_distinct_scores(kind):
    _, caller = NMS[kind]
    for seed in range(20):
        b = _nms_boxes(seed, distinct_scores=True)
        for thr in (0.25, 0.5):
            for old_type in (False, True):
                assert caller(b, thr, old_type) == \
                    caller(b, thr, old_type, plain=True), (seed, thr)


def test_the_higher_index_wins_a_tie():
    """Three equal boxes at one score and a fourth apart: the C++ NMS
    keeps the highest index of the three (a stable ascending sort popped
    from the back)."""
    boxes = np.tile([[0, 0, 0, 1, 1, 1, 0.5]], (4, 1)).astype(np.float64)
    boxes[0] = [5, 5, 5, 6, 6, 6, 0.25]
    assert nms_3d_faster(boxes, 0.25) == [3, 0]


def _voc_inputs(seed):
    """Detections (already in descending confidence) and ground truths
    of 4 images, integer corners so that some IoUs hit the threshold."""
    rng = np.random.RandomState(seed)
    lo = rng.randint(0, 5, (40, 3)).astype(np.float64)
    det = np.concatenate([lo, lo + rng.randint(1, 4, (40, 3))], 1)
    glo = rng.randint(0, 5, (12, 3)).astype(np.float64)
    gt = np.concatenate([glo, glo + rng.randint(1, 4, (12, 3))], 1)
    return det, rng.randint(0, 4, 40), gt, rng.randint(0, 4, 12)


@pytest.mark.parametrize("ovthresh", [0.25, 0.5])
def test_voc_match_equals_the_jax_one(ovthresh):
    hits = 0
    for seed in range(10):
        args = _voc_inputs(seed)
        tp, fp = native.voc_match_native(*args, ovthresh)
        jtp, jfp = jnative.voc_match_native(*args, ovthresh)
        assert tp.dtype == jtp.dtype == np.uint8
        np.testing.assert_array_equal(tp, jtp)
        np.testing.assert_array_equal(fp, jfp)
        np.testing.assert_array_equal(tp + fp, 1)
        hits += int(tp.sum())
    assert hits > 0


def _scenes(seed, n_img=4, n_gt=6, n_pred=20):
    """Parsed predictions (distinct scores) and ground truths of `n_img`
    scenes, 3 classes; the predictions are shifted copies of ground
    truths and random boxes."""
    rng = np.random.RandomState(seed)
    pred_all, gt_all = {}, {}
    scores = rng.permutation(n_img * n_pred) / (n_img * n_pred)
    for im in range(n_img):
        center = rng.rand(n_gt, 3) * 4
        size = rng.rand(n_gt, 3) + 0.3
        gcls = rng.randint(0, 3, n_gt)
        gt = get_3d_box_batch(size, np.zeros(n_gt), center)
        gt_all[im] = [(int(c), gt[j]) for j, c in enumerate(gcls)]
        src = rng.randint(0, n_gt, n_pred)
        pc = center[src] + rng.randn(n_pred, 3) * 0.2 * size[src]
        ps = size[src] * rng.uniform(0.7, 1.3, (n_pred, 3))
        pcls = np.where(rng.rand(n_pred) < 0.8, gcls[src],
                        rng.randint(0, 3, n_pred))
        corners = get_3d_box_batch(ps, np.zeros(n_pred), pc)
        pred_all[im] = [(int(c), corners[j],
                         float(scores[im * n_pred + j]))
                        for j, c in enumerate(pcls)]
    return pred_all, gt_all


def test_eval_det_equals_its_plain_version_at_distinct_scores():
    nonzero = 0
    for seed in range(8):
        pred_all, gt_all = _scenes(seed)
        for thr in (0.25, 0.5):
            calls = native.CALLS["voc_match"]
            rec, prec, ap = eval_det(pred_all, gt_all, thr)
            assert native.CALLS["voc_match"] == calls + 3
            rec_, prec_, ap_ = eval_det(pred_all, gt_all, thr, plain=True)
            assert native.CALLS["voc_match"] == calls + 3
            assert ap == ap_
            for c in ap:
                np.testing.assert_array_equal(rec[c], rec_[c])
                np.testing.assert_array_equal(prec[c], prec_[c])
            nonzero += sum(v > 0 for v in ap.values())
    assert nonzero > 0


def test_points_in_boxes_equals_the_jax_one_and_numpy():
    rng = np.random.RandomState(3)
    points = rng.randint(0, 8, (2000, 3)).astype(np.float32)
    lo = rng.randint(0, 6, (50, 3))
    boxes = np.concatenate([lo, lo + rng.randint(0, 4, (50, 3))], 1)
    got = native.points_in_boxes_native(points, boxes)
    np.testing.assert_array_equal(
        got, jnative.points_in_boxes_native(points, boxes))
    want = ((points[None] >= boxes[:, None, :3])
            & (points[None] <= boxes[:, None, 3:])).all(-1).sum(-1)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.max() > 0


@pytest.mark.parametrize("with_color", [True, False])
@pytest.mark.parametrize("width", [3, 6])
def test_augment_fused_equals_the_jax_one_bit_for_bit(width, with_color):
    rng = np.random.RandomState(width)
    pc = (rng.rand(20000, width) * 8 - 2).astype(np.float32)
    color = rng.rand(20000, 3).astype(np.float32) if with_color else None
    M = _rot(31.0, 2) @ _rot(2.0, 0) @ np.diag([-1.0, 1.0, 1.0])
    noise = rng.rand(20000, 3) * 5e-3
    shift = rng.random_sample((1, 3)) - 0.5
    cscale = 0.98 + 0.04 * rng.random_sample((20000, 3))
    mean = np.array([109.8, 97.2, 83.8]) / 256
    outs = []
    for fn in (native.augment_fused_native, jnative.augment_fused_native):
        p = pc.copy()
        c = None if color is None else color.copy()
        fn(p, M, noise, shift, 0.99, c, cscale, mean)
        outs.append((p, c))
    (p, c), (jp, jc) = outs
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(p[:, 3:], pc[:, 3:])  # untouched
    assert not np.array_equal(p[:, :3], pc[:, :3])
    if with_color:
        np.testing.assert_array_equal(c, jc)


def _relative_err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("rotate", [True, False])
def test_augment_pointcloud_is_its_plain_version_within_1e6(rotate):
    rng = np.random.RandomState(11)
    pc = (rng.rand(50000, 3) * 6 - 1).astype(np.float32)
    color = rng.rand(50000, 3).astype(np.float32)
    before = native.CALLS["augment_fused"]
    for seed in range(3):
        got = augment_pointcloud(pc, color, rotate,
                                 np.random.RandomState(seed))
        plain = augment_pointcloud(pc, color, rotate,
                                   np.random.RandomState(seed), plain=True)
        for i in (0, 1):
            assert _relative_err(got[i], plain[i]) <= 1e-6
    assert native.CALLS["augment_fused"] == before + 3
    # an f64 cloud takes the numpy passes, as in the JAX package
    got = augment_pointcloud(pc.astype(np.float64), None, rotate,
                             np.random.RandomState(0))
    assert got[0].dtype == np.float64
    assert native.CALLS["augment_fused"] == before + 3


# ------------------------------------------------------ (d) no fallback

@pytest.fixture
def failing_compiler(monkeypatch, tmp_path):
    """`CXX=/bin/false` and an empty build directory; the library loaded
    again after the test."""
    monkeypatch.setenv("CXX", "/bin/false")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.library.cache_clear()
    yield tmp_path / "build"
    native.library.cache_clear()


@pytest.mark.parametrize("call", ["build", "read_ply", "augment", "nms",
                                  "eval_det"])
def test_a_failed_build_raises(failing_compiler, tmp_path, call):
    boxes = np.array([[0, 0, 0, 1, 1, 1, 0.5]] * 2)
    box = get_3d_box_batch(np.ones((1, 3)), np.zeros(1), np.zeros((1, 3)))
    run = {
        "build": native.build,
        "read_ply": lambda: read_ply(str(tmp_path / "missing.ply")),
        "augment": lambda: augment_pointcloud(
            np.zeros((8, 3), np.float32), None, True,
            np.random.RandomState(0)),
        "nms": lambda: nms_3d_faster(boxes, 0.25),
        "eval_det": lambda: eval_det({0: [(1, box[0], 0.5)]},
                                     {0: [(1, box[0])]}),
    }[call]
    with pytest.raises(RuntimeError, match="/bin/false .* exited 1"):
        run()
    assert sorted(os.listdir(failing_compiler)) == []


# ------------------------------------------- (e) the train-split script

STUDY_FLAGS = ["--tiny", "--device", "cpu", "--n_train", "1", "--n_val",
               "1", "--val_freq", "1", "--trainable_text",
               "--eval_train_split", "--eos_coef", "0.02",
               "--lr_decay_epochs", "1", "--epochs", "2"]


def _script():
    spec = importlib.util.spec_from_file_location(
        "train_split_eval_torch",
        osp.join(ROOT, "scripts", "train_split_eval_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _evaluate_apart(study, epoch):
    """`TrainTester.evaluate_one_epoch` of `ckpt_epoch_{epoch}.pth` on the
    train scenes of the trainval root, built from the study's pieces
    without the script."""
    from butd_detr_tpu_torch.config import Config
    from butd_detr_tpu_torch.data import DataLoader
    from butd_detr_tpu_torch.lang import SimpleTokenizer, tiny_roberta_config
    from butd_detr_tpu_torch.predict import build_model
    from butd_detr_tpu_torch.train import Trainer
    from butd_detr_tpu_torch.train.checkpoint import load_checkpoint
    from butd_detr_tpu_torch.train.harness import TrainTester
    from butd_detr_tpu_torch.train.study import (
        TINY_NPOINTS,
        accuracy_row,
        build_dataset,
    )

    with open(osp.join(study, "log", "config.json")) as f:
        raw = json.load(f)
    fields = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in raw.items() if k in fields})
    cfg = dataclasses.replace(cfg, log_dir=osp.join(study, "log_apart"))
    tester = TrainTester(cfg, device="cpu")
    ds = build_dataset(osp.join(study, "data"),
                       SimpleTokenizer(max_len=cfg.max_text_len), "val",
                       butd_cls=cfg.butd_cls, joint_det=False,
                       num_points=cfg.num_points, eval_train=True)
    loader = DataLoader(ds, batch_size=cfg.batch_size, shuffle=False,
                        drop_last=False, num_workers=0)
    trainer = Trainer(cfg, model=build_model(cfg, tiny_roberta_config(),
                                             TINY_NPOINTS), device="cpu")
    assert load_checkpoint(osp.join(study, "log", f"ckpt_epoch_{epoch}.pth"),
                           trainer) == epoch + 1
    return accuracy_row(cfg, tester.evaluate_one_epoch(epoch, loader,
                                                       trainer))


@pytest.mark.parametrize("setup", ["butd_cls", "butd"])
def test_train_split_eval_rows_equal_evaluate_one_epoch(tmp_path, setup):
    from butd_detr_tpu_torch.train.study import main as study_main

    study = str(tmp_path / "study")
    study_main(STUDY_FLAGS + ["--out", study]
               + (["--butd_cls"] if setup == "butd_cls" else []))
    rows = _script().main(["--study", study, "--device", "cpu"])
    with open(osp.join(study, "train_split_eval.jsonl")) as f:
        assert [json.loads(line) for line in f] == rows
    assert [r["epoch"] for r in rows] == [1, 2]
    keys = (["acc_last_bbs", "acc_proposal_bbs", "acc_last_bbf",
             "acc_proposal_bbf"] if setup == "butd_cls" else
            [f"acc@{t}_top{k}_{m}" for t in (0.25, 0.5) for k in (1, 5)
             for m in ("bbs", "bbf")])
    with open(osp.join(study, "history.jsonl")) as f:
        history = {r["epoch"]: r for r in map(json.loads, f)}
    for row in rows:
        assert list(row) == ["epoch", *keys]
        assert all(0.0 <= row[k] <= 1.0 for k in keys)
        epoch = row["epoch"]
        assert row == {k: v for k, v in history[epoch].items()
                       if k != "step"}
        assert row == {"epoch": epoch, **_evaluate_apart(study, epoch)}
