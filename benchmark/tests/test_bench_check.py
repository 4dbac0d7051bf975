"""The comparison that decides `correct`, at a size a CPU test run holds:
the reference follows the program's plain path to rounding, a run with the
timed path broken underneath comes out not correct, and nothing of JAX or
of the JAX package is loaded. The control on the card is `cuda`-marked."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.harness import report
from benchmark.tests.tiny import tiny_cell

SEED = 2 ** 31 + 77


def _run(name, fault=None, f32=False, seed=SEED):
    c = tiny_cell(name)
    if f32:  # the program's f32 path: no bf16 MLPs or attention operands
        c["config"]["flags"].update(backbone_bf16=False, attn_precise=True)
    return cells.run_cell(c, seed, 0.05, False, device="cpu", fault=fault)


def test_reference_follows_the_f32_program_training():
    n = _run("cls_train_b24", f32=True)["numbers"]
    assert n["fps_mismatch"] == 0 and n["kps_gap"] == 0.0
    # the three steps' losses and the first gradient to rounding; the
    # change after three AdamW steps within a few % (round-off in the
    # smallest gradients moves AdamW's normalised steps)
    assert n["loss_gap"] < 2e-3
    assert n["grad_gap"] < 1e-3
    assert n["update_gap"] < 0.1


@pytest.mark.parametrize("name", ["cls_eval_b24", "det_eval_b24"])
def test_reference_follows_the_f32_program_evaluation(name):
    n = _run(name, f32=True)["numbers"]
    assert n["fps_mismatch"] == 0 and n["kps_gap"] == 0.0
    assert n["out_gap"] < 1e-4
    assert n["hits_diff"] == 0
    if "loss_gap" in n:
        assert n["loss_gap"] < 1e-4 and n["match_gap"] == 0.0


@pytest.mark.parametrize("name,fault", [
    ("cls_train_b24", "unchanged"),
    ("cls_train_b24", "half_batch"),
    ("det_eval_b24", "half_batch"),
    ("det_eval_b24", "altered"),
    ("det_eval_b24", "head"),
    ("cls_eval_b24", "half_batch"),
    ("cls_eval_b24", "altered"),
    ("cls_eval_b24", "head"),
])
def test_a_broken_timed_path_is_not_correct(name, fault):
    """The cell's own limits, the harness's whole run but the look for a
    chip, and one fault planted underneath the entry."""
    res = _run(name, fault=fault)
    assert res["correct"] is False, res["checks"]
    if fault == "head":  # one wrong answer among 30: the widest catches it
        c = res["checks"]["answer_gap"]
        assert c["value"] > c["limit"], res["checks"]


def test_the_result_line_and_no_jax():
    c = tiny_cell("det_eval_b24")
    res = cells.run_cell(c, SEED, 0.05, False, device="cpu")
    line = report.result(c, res, False, "cpu")
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"setup_s", "eval_scenes_per_s",
                                    "eval_batch_ms_p95"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert report.forbidden_modules() == []


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "butd_detr_tpu_torch_fake", sys)
    assert "butd_detr_tpu" not in report.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert report.forbidden_modules() == ["jaxlib"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.model, "
            "benchmark.reference.loss, benchmark.reference.evaluate; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    loaded = set(eval(out.stdout.strip()))
    assert not loaded & {"jax", "jaxlib", "flax", "butd_detr_tpu",
                         "butd_detr_tpu_torch"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cls_train_b24", "det_eval_b24",
                                  "cls_eval_b24"])
def test_the_control_is_not_correct_on_the_card(name):
    """The program's --use_bf16 path in the program's place, at the cell's
    own size on the card: `correct` comes out false."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(SEED), "--seconds", "3", "--trace", "0", "--control", "1"],
        cwd=root, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] \
        is False
