"""`demo_torch.py`, the port's quickstart, on the CPU: a schema-exact
mini-ScanNet of 8 scans, one epoch of the tiny configuration through the
port's `TrainTester` (checkpoint and grounding evaluation included), then
one grounded request through `GroundingPredictor`."""

import json
import os.path as osp
from torch_threads import one_torch_thread  # noqa: F401


def test_demo_runs_on_the_cpu(tmp_path, capsys):
    import demo_torch

    demo_torch.main(["--device", "cpu", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("[demo] OK")
    start = out.index("[demo] top boxes (cxcyczwhd):\n") + len(
        "[demo] top boxes (cxcyczwhd):\n")
    top = json.loads(out[start:out.rindex("[demo] OK")])
    assert len(top["boxes"]) == 3 and len(top["scores"]) == 3
    assert osp.exists(tmp_path / "log" / "ckpt_epoch_1.pth")
