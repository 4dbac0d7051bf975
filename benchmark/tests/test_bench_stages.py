"""The reduction of the program's stage spans (`harness/stages.py`) on
synthetic traces: each idle gap of the device goes to the innermost stage
open on the host when it began (`match` to `loss`, `hits` to
`evaluate`), the rest to `root` or `outside`; the shares sum to the
window's idle; the device's projections of host ranges are no device
work; each reading belongs to one mode."""

import pytest

from benchmark.harness import stages, trace
from butd_detr_tpu_torch.utils.spans import Record


def _ev(name, ts, dur, cat="user_annotation"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def _kernel(ts, dur):
    return _ev("k", ts, dur, "kernel")


def _train_trace():
    """One step in a 200-µs window: device busy 0-10, 40-50, 90-100,
    150-160; the host in the loop, then the step's stages."""
    return [
        _ev(trace.WINDOW, 0.0, 200.0),
        _ev("bench.train_step", 5.0, 180.0),
        _ev("train_step", 5.0, 180.0),
        _ev("forward", 10.0, 30.0),            # gap 10-40: forward
        _ev("backbone", 10.0, 20.0),
        _ev("loss", 50.0, 40.0),               # gap 50-90: match -> loss
        _ev("match", 60.0, 10.0),
        _ev("aten::mm", 50.0, 5.0, "cpu_op"),  # no span: ops are no stage
        _ev("backward", 100.0, 30.0),          # gap 100-150: backward, root
        _ev("optimizer", 160.0, 20.0),         # gap 160-200: optimizer ...
        _ev("Optimizer.step#AdamW.step", 165.0, 10.0),
        # the device's projection of a host range covers the gaps: no work
        _ev("loss", 0.0, 200.0, "gpu_user_annotation"),
        _kernel(0.0, 10.0), _kernel(40.0, 10.0), _kernel(90.0, 10.0),
        _kernel(150.0, 10.0),
    ]


def test_gaps_go_to_the_innermost_stage_open_when_each_began():
    r = stages.stage_idle(_train_trace(), steps=2)
    s = r["stages"]
    # ms a step of 2: µs * 1e-3 / 2
    assert s["forward"] == pytest.approx(30 * 1e-3 / 2)
    assert s["loss"] == pytest.approx(40 * 1e-3 / 2)        # match rolled up
    assert s["backward"] == pytest.approx(50 * 1e-3 / 2)    # began in it
    assert s["optimizer"] == pytest.approx(40 * 1e-3 / 2)
    assert s["root"] == 0.0 and s["outside"] == 0.0
    assert "evaluate" not in s and "readback" not in s       # never opened
    spans = r["spans"]
    assert spans["backbone"] == pytest.approx(30 * 1e-3 / 2)
    assert spans["loss"] == pytest.approx(40 * 1e-3 / 2)
    assert spans["optimizer"] == pytest.approx(40 * 1e-3 / 2)


def test_root_outside_and_hits_roll_up():
    events = [
        _ev(trace.WINDOW, 0.0, 100.0),
        _ev("bench.eval_step", 0.0, 40.0),
        _ev("eval_step", 2.0, 28.0),           # gap 5-20: root
        _ev("to_device", 2.0, 2.0),
        _ev("bench.evaluate", 50.0, 50.0),
        _ev("evaluate", 50.0, 45.0),
        _ev("hits", 50.0, 20.0),               # gap 55-70: hits -> evaluate
        _ev("readback", 70.0, 20.0),           # gap 75-90: readback
        _kernel(0.0, 5.0), _kernel(20.0, 10.0), _kernel(50.0, 5.0),
        _kernel(70.0, 5.0), _kernel(90.0, 10.0),
    ]
    r = stages.stage_idle(events, steps=1)
    s = r["stages"]
    assert s["root"] == pytest.approx(15e-3)
    assert s["outside"] == pytest.approx(20e-3)  # 30-50: the loop
    assert s["evaluate"] == pytest.approx(15e-3)
    assert s["readback"] == pytest.approx(15e-3)
    assert r["spans"]["hits"] == pytest.approx(15e-3)
    assert r["spans"]["eval_step"] == pytest.approx(15e-3)
    assert r["spans"]["outside"] == pytest.approx(20e-3)


@pytest.mark.parametrize("make", [_train_trace, lambda: [
    _ev(trace.WINDOW, 0.0, 50.0), _ev("eval_step", 10.0, 10.0),
    _kernel(0.0, 5.0), _kernel(3.0, 4.0), _kernel(45.0, 20.0)]])
def test_the_shares_sum_to_the_windows_idle(make):
    events = make()
    r = stages.stage_idle(events, steps=3)
    w = next(e for e in events if e["name"] == trace.WINDOW)
    busy = trace._union([(e["ts"], min(e["ts"] + e["dur"], w["dur"]))
                         for e in events if e["cat"] == "kernel"])
    idle = (w["dur"] - sum(b - a for a, b in busy)) * 1e-3 / 3
    assert r["total_ms"] == pytest.approx(idle)
    assert sum(r["stages"].values()) == pytest.approx(idle)
    assert sum(r["spans"].values()) == pytest.approx(idle)


def test_a_trace_without_the_window_is_an_error():
    with pytest.raises(RuntimeError):
        stages.stage_idle([_kernel(0.0, 1.0)], steps=1)


def test_segment_a_gives_ms_a_step_the_roots_and_the_read_backs():
    totals = {"eval_step": {"calls": 2, "ns": 4_000_000, "self_ns": 1_000_000},
              "readback": {"calls": 4, "ns": 2_000_000, "self_ns": 2_000_000}}
    records = [Record("readback", "evaluate", 1, 0, 500_000),
               Record("readback", None, 1, 0, 1_000_000),
               Record("eval_step", None, 1, 0, 4_000_000)]
    r = stages.reduce_spans(totals, records, {"calls": 3, "bytes": 10},
                            {"calls": 7, "bytes": 50}, steps=2)
    assert r["spans"]["eval_step"] == {"calls": 1.0, "ms": 2.0,
                                       "self_ms": 0.5}
    assert r["roots"] == {"readback": 0.5, "eval_step": 2.0}
    assert r["readbacks"] == 2.0 and r["readback_bytes"] == 20.0


class _Run:
    def __init__(self, mode, idle, host):
        self.mode = mode
        self.stages = {"idle": {"stages": idle}, "host": {"spans": host}}


def test_each_reading_belongs_to_one_mode():
    idle = {"forward": 1.0, "loss": 2.0, "backward": 3.0, "optimizer": 4.0,
            "root": 0.5, "outside": 0.5}
    train = stages.readings(_Run("train", idle, {"readback": {"ms": 9.0}}))
    assert train == {"forward_idle_ms.train": 1.0, "loss_idle_ms.train": 2.0,
                     "backward_idle_ms.train": 3.0,
                     "optimizer_idle_ms.train": 4.0}
    # the control cell: no loss, so no loss reading
    ev = stages.readings(_Run("eval", {"forward": 1.0, "evaluate": 2.0,
                                       "readback": 3.0, "root": 0.0,
                                       "outside": 0.0},
                              {"readback": {"ms": 9.0}}))
    assert ev == {"forward_idle_ms.eval": 1.0, "evaluate_idle_ms.eval": 2.0,
                  "readback_idle_ms.eval": 3.0,
                  "readback_wait_ms.eval": 9.0}
    assert stages.readings(object()) == {}
