"""The reduction of a device trace: busy time as the union of the device's
intervals, the traced window from its first operation to the end of its
last, the idle share from those two alone, and idle gaps named by the host
span open when each began."""

import pytest

from benchmark.harness import readers, trace


def _dev(name, ts, dur, cat="kernel"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_is_the_union_and_the_window_spans_the_device_operations():
    events = [
        _dev("void k1<float>(float*)", 100.0, 50.0),
        _dev("k2", 120.0, 60.0),            # overlaps k1: 100-180
        _dev("Memcpy HtoD", 300.0, 20.0, "gpu_memcpy"),
        _dev("Memset", 400.0, 100.0, "gpu_memset"),
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0.0,
         "dur": 900.0},                     # host side: not the device's
    ]
    r = trace.reduce_device(events)
    assert r["window_s"] == pytest.approx(400e-6)
    assert r["busy_s"] == pytest.approx((80 + 20 + 100) * 1e-6)
    assert [k[0] for k in r["kernels"]] == ["void k1<float>(float*)", "k2"]
    assert dict((n, s) for n, s in r["device_ops"])["k1"] == \
        pytest.approx(50e-6)


def test_a_trace_without_device_operations_is_an_error():
    with pytest.raises(RuntimeError):
        trace.reduce_device([{"cat": "cpu_op", "name": "aten::mm",
                              "ts": 0.0, "dur": 1.0}])


class _Run:
    mode = "train"

    def __init__(self, busy, window):
        self.trace = {"busy_s": busy, "window_s": window}


@pytest.mark.parametrize("busy,window,want", [
    (0.3, 0.4, 25.0), (0.4, 0.4, 0.0), (0.5, 0.4, -25.0)])
def test_idle_share_is_read_from_the_trace_unclamped(busy, window, want):
    """A busy time over the window reads below 0, so that the fault shows
    instead of being clamped away."""
    assert readers.idle_share(_Run(busy, window), "train") == \
        pytest.approx(want)
    assert readers.idle_share(_Run(busy, window), "eval") is None


def test_idle_gaps_are_named_by_the_host_span_open_when_each_began():
    events = [
        {"cat": "user_annotation", "name": trace.WINDOW, "ts": 0.0,
         "dur": 100.0},
        {"cat": "user_annotation", "name": "bench.train_step", "ts": 0.0,
         "dur": 60.0},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 10.0, "dur": 20.0},
        _dev("k", 0.0, 10.0),
        _dev("k", 40.0, 20.0),
    ]
    gaps = dict((n, s) for n, s in trace.idle_gaps(events))
    assert gaps["bench.train_step/aten::mm"] == pytest.approx(30e-6)
    assert gaps["outside any host span"] == pytest.approx(40e-6)
