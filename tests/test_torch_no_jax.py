"""The port imports no JAX. In a fresh process, every module of
`butd_detr_tpu_torch` (`train/study.py`, `parallel/`, the span predictor,
the class embeddings, `native.py` and `utils/visualize.py` included), one
of the port's study command lines (`scripts/*_torch.py` of the accuracy
study, `scripts/train_split_eval_torch.py` among them,
`scripts/pretrain_text_torch.py`, the two timers
`scripts/bench_{backward,input_pipeline}_torch.py`) or one of its entry
points at the
repository's root (`predict_torch.py`, `train_torch.py`,
`prepare_data_torch.py`, `span_cls_torch.py`,
`gen_class_embeddings_torch.py`, `demo_torch.py`, `chip_smoke.py`) is
imported; an entry point's `main`, the pretraining script's and the
backward timer's (not
`chip_smoke.py`'s, whose phases import the port lazily and which the
package-wide case covers) then runs on arguments that stop it once it has
imported what it needs (a data root that does not exist, no GPU). The
process must then hold no module of `jax`, `flax`, `optax`, the JAX
package, the JAX package's study scripts (`scripts.probe_common`,
`scripts.train_split_eval`) or its benchmark (`bench`). The host C++
runtime (`butd_detr_tpu_torch.native`) loads, builds if need be and runs
in a process that imports neither JAX nor torch."""

import os
import subprocess
import sys
import textwrap

import pytest
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("accuracy_study_torch.py", "overfit_probe_torch.py",
           "diag_grounding_torch.py", "pretrain_text_torch.py",
           "train_split_eval_torch.py", "bench_backward_torch.py",
           "bench_input_pipeline_torch.py")
MISSING = "/nonexistent/data_root"
ENTRY_POINTS = {
    "predict_torch.py": ["--scan_id", "scene0000_00", "--utterance", "a",
                         "--data_root", MISSING],
    "train_torch.py": ["--data_root", MISSING, "--log_dir", "{tmp}/log"],
    "prepare_data_torch.py": ["--data_root", MISSING, "--num_workers", "1"],
    "span_cls_torch.py": ["--data_root", MISSING, "--checkpoint_path",
                          "{tmp}/ck"],
    "gen_class_embeddings_torch.py": ["--output", "{tmp}/table.npy"],
    "demo_torch.py": ["--workdir", "{tmp}/demo"],
    "pretrain_text_torch.py": ["--out", "{tmp}/text_init.npz"],
    "bench_backward_torch.py": [],
}


@pytest.mark.parametrize("what", ["butd_detr_tpu_torch", *SCRIPTS,
                                  *(e for e in ENTRY_POINTS
                                    if e not in SCRIPTS),
                                  "chip_smoke.py"])
def test_imports_no_jax(what, tmp_path):
    if what == "butd_detr_tpu_torch":
        load = textwrap.dedent("""
            import importlib, pkgutil
            import butd_detr_tpu_torch as pkg
            names = [m.name for m in pkgutil.walk_packages(
                pkg.__path__, pkg.__name__ + ".")]
            assert {"butd_detr_tpu_torch.train.study",
                    "butd_detr_tpu_torch.parallel.mesh",
                    "butd_detr_tpu_torch.parallel.tp",
                    "butd_detr_tpu_torch.parallel.collectives",
                    "butd_detr_tpu_torch.lang.span_predictor",
                    "butd_detr_tpu_torch.lang.span_trainer",
                    "butd_detr_tpu_torch.lang.class_embeddings",
                    "butd_detr_tpu_torch.native",
                    "butd_detr_tpu_torch.utils.visualize"} <= set(names)
            for name in names:
                importlib.import_module(name)
            """)
    else:
        load = textwrap.dedent(f"""
            import importlib.util
            spec = importlib.util.spec_from_file_location(
                "cli", {os.path.join(ROOT, "scripts" if what in SCRIPTS
                                     else "", what)!r})
            cli = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(cli)
            """)
    if what in ENTRY_POINTS:
        argv = [a.format(tmp=tmp_path) for a in ENTRY_POINTS[what]]
        load += textwrap.dedent(f"""
            import sys
            sys.argv = [{what!r}, *{argv!r}]
            try:
                cli.main()
            except (OSError, RuntimeError) as e:  # no data root, no GPU
                print(type(e).__name__, e, file=sys.stderr)
            """)
    code = load + textwrap.dedent("""
        import sys
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "optax", "butd_detr_tpu")
                     or m in ("scripts.probe_common",
                              "scripts.train_split_eval", "bench"))
        print(bad)
        """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_native_runs_without_torch():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from butd_detr_tpu_torch import native
        keep = native.greedy_nms_native(np.zeros((2, 3)), np.ones((2, 3)),
                                        np.array([0.5, 0.5]), 0.25)
        print(keep)
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "butd_detr_tpu", "torch")))
        """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines() == ["[1]", "[]"]
