"""BENCHMARK.json against the benchmark's contract, and the harness finding
every file of a cell by its name."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size(bench):
    assert set(bench) == KEYS
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32
    assert all(_text(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_check_fits_with_24_cells(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entry_keys(bench):
    seen = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["source"]) and _text(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] in (1, 4) and _text(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in bench["end_to_end"]:
        allowed = {"name", "unit", "better", "bound", "source", "workloads"}
        assert set(m) <= allowed
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        allowed = {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"}
        assert set(m) <= allowed
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(m["layer"])
    names = [x["name"] for x in bench["configs"]] + \
        [x["name"] for x in bench["workloads"]]
    assert len(names) == len(set(names))


def test_every_workload_names_files_that_exist(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        cell = spec.load_cell(w["name"])
        # the cell's own file agrees with BENCHMARK.json
        assert cell["entry"]["config"] == w["config"]
        assert cell["entry"]["traffic"] == w["traffic"]
        assert cell["entry"]["why"] == w["why"]
    assert used == set(configs)
    for c in bench["configs"]:
        path = os.path.join(spec.ROOT, c["file"])
        assert os.path.exists(path)
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert json.load(open(path))["reduced"] == c["reduced"]
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_moves_points_to_an_end_to_end_metric_its_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert spec.reports(e2e[m["moves"]], cell), (m["name"], cell)
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    for cell in cells:
        reported = [m["name"] for m in bench["end_to_end"]
                    if spec.reports(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(spec.reports(m, cell) for m in bench["per_layer"])
    # metrics of one layer give one name, letter for letter
    assert {m["layer"] for m in bench["per_layer"]} == {
        "train step", "eval step", "evaluators", "model", "kernels",
        "device"}


def test_each_pair_of_config_and_traffic_once(bench):
    """The benchmark's contract lists a pair of configuration and traffic
    once: a cell is known by what it runs, not only by its name."""
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_chip_cells_within_the_quarter(bench):
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_a_cell_is_added_by_adding_files(tmp_path):
    """A throwaway cell, traffic mix, metric and roofline function in a
    copy of the benchmark: found by name, with no file edited but
    BENCHMARK.json."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = spec.benchmark()
    w = dict(bench["workloads"][0], name="cls_train_b12",
             traffic="sr3d_dense")
    bench["workloads"].append(w)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cls_train_b24" in m.get("workloads", []):
            m["workloads"].append("cls_train_b12")
    bench["per_layer"].append({
        "name": "loader_wait_share.train", "unit": "%", "better": "lower",
        "source": "host_clock", "layer": "train step",
        "moves": "train_scenes_per_s", "workloads": ["cls_train_b12"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = json.load(open(root / "benchmark/workloads/cls_train_b24.json"))
    cell.update(batch=12, traffic="sr3d_dense")
    (root / "benchmark/workloads/cls_train_b12.json").write_text(
        json.dumps(cell))
    mix = json.load(open(root / "benchmark/traffic/sr3d_joint_train.json"))
    mix["objects"] = {"dist": "uniform", "min": 60, "max": 120}
    (root / "benchmark/traffic/sr3d_dense.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/loader_wait_share.train.py").write_text(
        "def read(run):\n    return None\n")
    (root / "benchmark/rooflines/fps.rewrite.json").write_text(json.dumps(
        {"function": "fps", "patterns": ["fps_v2_kernel"]}))
    loaded = spec.load_cell("cls_train_b12", root=str(root))
    assert loaded["entry"]["batch"] == 12
    assert loaded["traffic"]["objects"]["min"] == 60
    assert [m["name"] for m in loaded["per_layer"]] == [
        "step_host_ms.train", "step_mfu.train", "kernels_roofline.train",
        "device_idle_share.train", "loader_wait_share.train"]
    assert spec.metric_reader("loader_wait_share.train",
                              root=str(root))(None) is None
    fps = spec.rooflines(root=str(root))["fps"]
    assert "fps_v2_kernel" in fps["patterns"]
    assert "fps_resident_kernel" in fps["patterns"]
    assert fps["formula"] == "fps"


def test_a_tree_without_the_program_gives_no_result(tmp_path):
    """Only BENCHMARK.json and the files under `paths`: the command exits
    with another code than 0 and prints no result line."""
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cls_train_b24", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=env)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_shape_expressions_are_arithmetic_only():
    assert spec.evaluate("np1*ns1 + max(B, 2)", {"np1": 4, "ns1": 3,
                                                  "B": 1}) == 14
    with pytest.raises(ValueError):
        spec.evaluate("__import__('os')", {})
