"""The port's data pipeline against the JAX package's, on the CPU, on one
`make_fake_scannet` root (2,000 points a scan) written by the JAX writer,
with a scan cache built by each package (1,024 points a scan, subsampled
without replacement as on ScanNet):

(a) the port's writers write the JAX writers' files byte for byte;
(b) `read_ply` equals the JAX package's `read_ply` (both through their
    host C++ readers; ascii through the Python parsers) and the JAX C++
    reader's columns, and the port's Python parser equals the JAX one;
(c) the scan caches hold the same scans, and a JAX-written cache loads in a
    fresh process that then holds no module of JAX, of the JAX package or
    of torch; a cache naming another class of the JAX package is refused;
(d) `augment_pointcloud` is bit-equal to the JAX default (each package's
    fused C++ pass), its plain path (`plain=True`, numpy) bit-equal to the
    JAX numpy path (`BUTD_NATIVE_AUGMENT=0`) and within 1e-6 of each
    array's largest magnitude of the fused pass;
(e) every key of every sample of the five datasets x two splits (train
    with augmentation, val without), `butd_cls` and `butd` + `augment_det`,
    at two sample seeds, equals the JAX dataset's bit for bit: the two
    defaults, and the port's plain augmentation against the JAX numpy
    one; with `use_multiview` too, its features written by the port's
    `make_fake_multiview` (the JAX writer's arrays);
(f) the loader with 2 spawned workers gives the batches of 0 workers and
    of the JAX loader, bit for bit, shuffled, with a padded tail;
(g) `get_tokenizer` picks the JAX package's tokenizer class, in a process
    where the HF hub is offline from its start.
"""

import functools
import os
import os.path as osp
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from butd_detr_tpu.data import JointGroundingDataset as JDataset
from butd_detr_tpu.data.augment import augment_pointcloud as j_augment
from butd_detr_tpu.data.loader import DataLoader as JDataLoader
from butd_detr_tpu.data.scan import (
    ScanNetMappings as JScanNetMappings,
    _read_ply_py as j_read_ply_py,
    read_ply as j_read_ply,
    load_scan_cache as j_load_scan_cache,
    save_scan_cache as j_save_scan_cache,
)
from butd_detr_tpu.data import synthetic as j_synthetic
from butd_detr_tpu.lang.tokenizer import SimpleTokenizer as JTokenizer
from butd_detr_tpu.native import ply_read_vertices_native
from butd_detr_tpu_torch.data import (
    DataLoader,
    JointGroundingDataset,
    Scan,
    augment_pointcloud,
    load_scan_cache,
    read_ply,
    save_scan_cache,
)
from butd_detr_tpu_torch.data import joint_dataset, synthetic
from butd_detr_tpu_torch.data.scan import _read_ply_py
from butd_detr_tpu_torch.native import (
    ply_read_vertices_native as p_ply_read_vertices_native,
)
from butd_detr_tpu_torch.lang.tokenizer import SimpleTokenizer
from torch_threads import one_torch_thread  # noqa: F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
KEEP_POINTS = 1024
TEXT_LEN = 64
DATASETS = ("sr3d", "sr3d+", "nr3d", "scanrefer", "scannet")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scannet")
    root = j_synthetic.make_fake_scannet(str(tmp / "root"),
                                         points_per_scan=2000)
    meta = osp.join(root, "meta_data")
    caches = {"jax": str(tmp / "jax_v3scans.pkl"),
              "port": str(tmp / "port_v3scans.pkl")}
    j_save_scan_cache(caches["jax"], "train", root, num_workers=1,
                      keep_points=KEEP_POINTS)
    save_scan_cache(caches["port"], "train", root, num_workers=1,
                    keep_points=KEEP_POINTS)
    return dict(root=root, meta=meta, caches=caches,
                jax_scans=j_load_scan_cache(caches["jax"], meta_dir=meta),
                scans=load_scan_cache(caches["port"], meta_dir=meta))


# ---------------------------------------------- (a) the on-disk writers

def _files(root):
    return sorted(osp.relpath(osp.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("writer, kw", [
    ("make_fake_scannet", dict(points_per_scan=1000, seed=3,
                               scan_ids=["scene0004_00", "scene0007_01"])),
    ("make_rich_scannet", dict(n_train=3, n_val=2, points_per_scan=1500,
                               seed=1)),
])
def test_writers_write_the_jax_writers_files(tmp_path, writer, kw):
    want = getattr(j_synthetic, writer)(str(tmp_path / "jax"), **kw)
    got = getattr(synthetic, writer)(str(tmp_path / "port"), **kw)
    assert _files(got) == _files(want)
    assert len(_files(got)) > 20
    for name in _files(want):
        with open(osp.join(want, name), "rb") as a, \
                open(osp.join(got, name), "rb") as b:
            assert a.read() == b.read(), name


# --------------------------------------------------- (b) the PLY reader

def _ascii_ply(path):
    rng = np.random.RandomState(2)
    xyz = rng.rand(7, 3).astype(np.float32)
    rgb = rng.randint(0, 255, (7, 3))
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\ncomment made by hand\n"
                "element vertex 7\nproperty float x\nproperty float y\n"
                "property float z\nproperty uchar red\nproperty uchar green\n"
                "property uchar blue\nelement face 0\n"
                "property list uchar int vertex_indices\nend_header\n")
        for p, c in zip(xyz, rgb):
            f.write(" ".join(map(repr, p.tolist())) + " "
                    + " ".join(map(str, c)) + "\n")
    return path


@pytest.mark.parametrize("kind", ["cloud", "labels", "ascii"])
def test_read_ply_equals_the_jax_readers(data, tmp_path, kind):
    sdir = osp.join(data["root"], "scans", "scene0001_00")
    path = {"cloud": osp.join(sdir, "scene0001_00_vh_clean_2.ply"),
            "labels": osp.join(sdir, "scene0001_00_vh_clean_2.labels.ply"),
            "ascii": _ascii_ply(str(tmp_path / "a.ply"))}[kind]
    for got, want in ((read_ply(path), j_read_ply(path)),
                      (_read_ply_py(path), j_read_ply_py(path))):
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got = read_ply(path)
    native = ply_read_vertices_native(path)
    mine = p_ply_read_vertices_native(path)
    if kind == "ascii":  # the C++ readers refuse it: both parse in Python
        assert native is None and mine is None
        return
    assert native is not None, "the JAX package's native reader did not load"
    for m, n in zip(mine, native):
        assert m.dtype == n.dtype
        np.testing.assert_array_equal(m, n)
    xyz, rgb, label = native
    np.testing.assert_array_equal(
        np.stack([got["x"], got["y"], got["z"]], 1), xyz)
    if kind == "cloud":
        np.testing.assert_array_equal(
            np.stack([got["red"], got["green"], got["blue"]], 1), rgb)
        assert "label" not in got and (label == -1).all()
    else:
        np.testing.assert_array_equal(got["label"], label)
        assert "red" not in got and not rgb.any()


# ------------------------------------------------------ (c) scan caches

def test_both_packages_build_the_same_scans(data):
    want, got = data["jax_scans"], data["scans"]
    assert list(got) == list(want) == ["scene0000_00", "scene0001_00"]
    for sid, w in want.items():
        g = got[sid]
        assert type(g) is Scan
        assert sorted(vars(g)) == sorted(vars(w))
        assert g.pc.shape == (KEEP_POINTS, 3)
        assert len(np.unique(g.choices)) == KEEP_POINTS  # no replacement
        for k in ("pc", "orig_pc", "color", "semantic_label_idx", "choices",
                  "new_pts"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k),
                                          err_msg=k)
        assert len(g.three_d_objects) == len(w.three_d_objects) == 3
        for a, b in zip(g.three_d_objects, w.three_d_objects):
            assert a["object_id"] == b["object_id"]
            assert a["instance_label"] == b["instance_label"]
            np.testing.assert_array_equal(a["points"], b["points"])
        assert g.mappings.meta_dir == w.mappings.meta_dir
        np.testing.assert_array_equal(g.get_object_bbox(1),
                                      w.get_object_bbox(1))


def test_a_jax_written_cache_loads_without_jax_or_torch(data):
    """A fresh process loads the JAX package's cache, builds the port's
    dataset on it and makes a sample: what a loader worker does. It then
    holds no module of JAX, flax, the JAX package or torch."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        from butd_detr_tpu_torch.data import JointGroundingDataset, Scan, \\
            load_scan_cache
        from butd_detr_tpu_torch.lang.tokenizer import SimpleTokenizer
        scans = load_scan_cache({data['caches']['jax']!r},
                                meta_dir={data['meta']!r})
        assert all(type(s) is Scan for s in scans.values())
        ds = JointGroundingDataset(
            dataset_dict={{"sr3d": 1, "scannet": 1}}, split="train",
            data_path={data['root']!r}, scans=scans, use_color=True,
            butd_cls=True, tokenizer=SimpleTokenizer(max_len=64))
        s = ds.get(2, np.random.RandomState(0))
        print(float(s["point_clouds"].sum()))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "flax", "butd_detr_tpu",
                                            "torch"))
        print(bad)
        """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    total, bad = out.stdout.strip().splitlines()
    assert bad == "[]"
    want = JDataset(dataset_dict={"sr3d": 1, "scannet": 1}, split="train",
                    data_path=data["root"], scans=data["jax_scans"],
                    use_color=True, butd_cls=True,
                    tokenizer=JTokenizer(max_len=64))
    assert float(total) == float(want.get(2, np.random.RandomState(0))[
        "point_clouds"].sum())


def test_a_cache_naming_another_jax_class_is_refused(tmp_path, data):
    path = str(tmp_path / "other.pkl")
    with open(path, "wb") as f:
        pickle.dump({"m": JScanNetMappings(data["meta"])}, f)
    with pytest.raises(pickle.UnpicklingError, match="ScanNetMappings"):
        load_scan_cache(path)


# ---------------------------------------------------- (d) augmentation

def _relative_err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("rotate", [True, False])
@pytest.mark.parametrize("with_color", [True, False])
def test_augment_pointcloud_matches_the_jax_package(monkeypatch, rotate,
                                                    with_color):
    rng = np.random.RandomState(4)
    pc = (rng.rand(3000, 3) * 6 - 1).astype(np.float32)
    color = rng.rand(3000, 3).astype(np.float32) if with_color else None
    for seed in range(3):
        got = augment_pointcloud(pc, color, rotate,
                                 np.random.RandomState(seed))
        plain = augment_pointcloud(pc, color, rotate,
                                   np.random.RandomState(seed), plain=True)
        monkeypatch.setenv("BUTD_NATIVE_AUGMENT", "0")
        numpy_path = j_augment(pc, color, rotate,
                               np.random.RandomState(seed))
        monkeypatch.setenv("BUTD_NATIVE_AUGMENT", "1")
        native = j_augment(pc, color, rotate, np.random.RandomState(seed))
        for mine, record in ((plain[2], numpy_path[2]), (got[2], native[2])):
            assert list(mine) == list(record)
            for k, v in record.items():
                np.testing.assert_array_equal(mine[k], v, err_msg=k)
        for i in (0, 1):
            if not with_color and i == 1:
                assert got[1] is None and plain[1] is None
                continue
            assert got[i].dtype == plain[i].dtype == np.float32
            np.testing.assert_array_equal(got[i], native[i])
            np.testing.assert_array_equal(plain[i], numpy_path[i])
            assert _relative_err(got[i], plain[i]) <= 1e-6
            assert not np.array_equal(got[i], pc if i == 0 else color)


# ------------------------------------------------------- (e) the datasets

def _datasets(data, dataset, split, **flags):
    dataset_dict = ({"sr3d": 1, "scannet": 2} if dataset == "scannet"
                    else {dataset: 1})
    kw = dict(dataset_dict=dataset_dict, test_dataset=dataset, split=split,
              data_path=data["root"], use_color=True,
              detect_intermediate=True, max_text_len=TEXT_LEN,
              max_num_obj=8, **flags)
    return (JointGroundingDataset(tokenizer=SimpleTokenizer(max_len=TEXT_LEN),
                                  scans=data["scans"], **kw),
            JDataset(tokenizer=JTokenizer(max_len=TEXT_LEN),
                     scans=data["jax_scans"], **kw))


def _assert_same_sample(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if not isinstance(w, np.ndarray):
            assert type(g) is type(w) and g == w, k
            continue
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("dataset", DATASETS)
def test_samples_equal_the_jax_datasets(data, monkeypatch, dataset, split):
    for flags in (dict(butd_cls=True), dict(butd=True, augment_det=True)):
        got, want = _datasets(data, dataset, split, **flags)
        assert len(got) == len(want) >= 2
        assert got.augment == (split == "train")
        for native in ("0", "1"):
            # "0": the port's plain augmentation against the JAX numpy one
            monkeypatch.setenv("BUTD_NATIVE_AUGMENT", native)
            monkeypatch.setattr(
                joint_dataset, "augment_pointcloud",
                functools.partial(augment_pointcloud, plain=native == "0"))
            for i in range(min(len(want), 4)):
                for seed in (0, 7):
                    _assert_same_sample(
                        got.get(i, np.random.RandomState(seed)),
                        want.get(i, np.random.RandomState(seed)))
    if dataset == "scannet" and split == "train":
        # the joint dataset mixes detection prompts in; both kinds compared
        assert {a["dataset"] for a in got.annos} == {"sr3d", "scannet"}


def test_multiview_samples_equal_the_jax_datasets(data, tmp_path):
    """`use_multiview`: the port's `make_fake_multiview` writes the JAX
    writer's features, and the samples (128 ENet channels after colour)
    equal the JAX dataset's; a dataset that has opened its file still
    pickles for the loader's workers and reads there."""
    import h5py

    root = tmp_path / "root"  # the fixture's root and the features file
    root.mkdir()
    for name in os.listdir(data["root"]):
        os.symlink(osp.join(data["root"], name), root / name)
    path = synthetic.make_fake_multiview(str(root), data["scans"], dim=128,
                                         seed=3)
    want_path = j_synthetic.make_fake_multiview(
        str(tmp_path / "jax"), data["jax_scans"], dim=128, seed=3)
    with h5py.File(path, "r") as f, h5py.File(want_path, "r") as w:
        assert sorted(f) == sorted(w) == sorted(data["scans"])
        for sid in w:
            np.testing.assert_array_equal(f[sid][()], w[sid][()])
    for split in ("train", "val"):
        got, want = _datasets(dict(data, root=str(root)), "sr3d", split,
                              butd_cls=True, use_multiview=True)
        assert len(got) == len(want) >= 2
        for i in range(min(len(want), 3)):
            for seed in (0, 7):
                g = got.get(i, np.random.RandomState(seed))
                _assert_same_sample(g, want.get(
                    i, np.random.RandomState(seed)))
        assert g["point_clouds"].shape[-1] == 3 + 3 + 128
    again = pickle.loads(pickle.dumps(got))
    _assert_same_sample(again.get(1, np.random.RandomState(2)),
                        got.get(1, np.random.RandomState(2)))


# --------------------------------------------------------- (f) the loader

def test_loader_workers_give_the_inline_and_jax_batches(data):
    got_set, want_set = _datasets(data, "scannet", "train", butd_cls=True)
    kw = dict(batch_size=4, shuffle=True, drop_last=False, seed=5)
    workers = DataLoader(got_set, num_workers=2, **kw)
    inline = DataLoader(got_set, num_workers=0, **kw)
    jax_loader = JDataLoader(want_set, num_workers=0, **kw)
    try:
        for epoch in (1, 2):
            for loader in (workers, inline, jax_loader):
                loader.set_epoch(epoch)
            got = list(workers)
            assert len(got) == len(inline) == 2 and got[-1]["__valid__"] == 2
            for other in (list(inline), list(jax_loader)):
                assert len(other) == len(got)
                for g, w in zip(got, other):
                    _assert_same_sample(g, w)
    finally:
        workers.close()
    assert workers._pool is None


# ------------------------------------------------------ (g) the tokenizer

def test_get_tokenizer_picks_the_jax_packages_tokenizer():
    code = textwrap.dedent("""
        from butd_detr_tpu.lang.tokenizer import get_tokenizer as want
        from butd_detr_tpu_torch.lang.tokenizer import get_tokenizer as got
        a, b = got(max_len=32), want(max_len=32)
        text = ["the chair near the table . not mentioned"]
        print(type(a).__name__, type(b).__name__,
              (a(text).ids == b(text).ids).all())
        """)
    env = dict(os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got, want, same_ids = out.stdout.split()
    assert got == want and same_ids == "True"
