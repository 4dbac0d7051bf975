"""The port imports no JAX. In a fresh process, every module of
`butd_detr_tpu_torch` (`train/study.py` included) or one of the port's
study command lines (`scripts/*_torch.py` of the accuracy study) is
imported; the process must then hold no module of `jax`, `flax`, the JAX
package or the JAX package's study scripts (`scripts.probe_common`,
`scripts.train_split_eval`)."""

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("accuracy_study_torch.py", "overfit_probe_torch.py",
           "diag_grounding_torch.py")


@pytest.mark.parametrize("what", ["butd_detr_tpu_torch", *SCRIPTS])
def test_imports_no_jax(what):
    if what == "butd_detr_tpu_torch":
        load = textwrap.dedent("""
            import importlib, pkgutil
            import butd_detr_tpu_torch as pkg
            names = [m.name for m in pkgutil.walk_packages(
                pkg.__path__, pkg.__name__ + ".")]
            assert "butd_detr_tpu_torch.train.study" in names
            for name in names:
                importlib.import_module(name)
            """)
    else:
        load = textwrap.dedent(f"""
            import importlib.util
            spec = importlib.util.spec_from_file_location(
                "cli", {os.path.join(ROOT, "scripts", what)!r})
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
            """)
    code = load + textwrap.dedent("""
        import sys
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "butd_detr_tpu")
                     or m in ("scripts.probe_common",
                              "scripts.train_split_eval"))
        print(bad)
        """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
