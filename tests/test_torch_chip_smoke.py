"""chip_smoke.py refuses to report anything where it cannot run: with no
CUDA device, and in a directory that holds the script and nothing else of
the repository (there with CUDA made to look available, so the check that
fails is the missing package)."""

import os
import shutil
import subprocess
import sys
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)


def _no_result(proc):
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_fails_without_a_gpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a GPU is present")
    proc = _run([SCRIPT], cwd=str(tmp_path))
    _no_result(proc)
    assert "no CUDA device" in proc.stderr


def test_fails_alone_in_a_directory(tmp_path):
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(SCRIPT, lone / "chip_smoke.py")
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    proc = _run(["-c", code], cwd=str(lone))
    _no_result(proc)
    assert "package is missing" in proc.stderr
