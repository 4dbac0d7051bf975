"""The device trace, reduced to what the per-layer metrics read.

A traced run records two segments after its measured window, which runs
untraced. The first runs under a profiler that records the device's
activity alone (kernels, copies, sets): its reduction gives the device's
busy time (the union of those intervals), the traced segment's length
(from the first device operation to the end of the last) and each
kernel's device time. The second, shorter, runs under a profiler that
records the host's operations too (its Chrome trace is written to
`TMPDIR`, read back and deleted): it names each idle gap by what the host
was doing when the gap began, for the breakdown. Its window is the
benchmark's `bench.window` span, which ends after the device has finished.
Both recordings slow the host, not the device, so the traced segments idle
more than the window does."""

import contextlib
import json
import os
import tempfile
from typing import Callable, Dict, Iterator, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "bench.window"


def _ns(e, what: str) -> float:
    """An event's start or duration in ns (`start_ns`; `start_us` on
    older PyTorch)."""
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else 1e3 * getattr(e, f"{what}_us")()


def _device_events(prof) -> List[Dict]:
    """The device's operations among the profiler's events, as {"cat",
    "name", "ts", "dur"} in µs from the earliest: a copy or a set by its
    name, every other operation on the device a kernel (the benchmark's
    own annotations, projected onto the device, left out)."""
    raw = [(e.name(), _ns(e, "start"), _ns(e, "duration"))
           for e in prof.profiler.kineto_results.events()
           if str(e.device_type()).endswith("CUDA")
           and not e.name().startswith("bench.")]
    t0 = min((r[1] for r in raw), default=0.0)
    return [{"cat": "gpu_memcpy" if n.startswith("Memcpy") else
             "gpu_memset" if n.startswith("Memset") else "kernel",
             "name": n, "ts": (s - t0) * 1e-3, "dur": d * 1e-3}
            for n, s, d in raw]


@contextlib.contextmanager
def device_window() -> Iterator[Dict]:
    """Profile the device alone while the block runs; on leaving, the
    yielded dict holds `reduce_device` of the trace."""
    from torch.profiler import ProfilerActivity, profile

    out: Dict = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield out
        torch.cuda.synchronize()
    out.update(reduce_device(_device_events(prof)))


def record(segment: Callable[[], None]) -> List[Dict]:
    """Run `segment` under the profiler of host and device; its Chrome
    trace events (written to `TMPDIR`, read back and deleted)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            segment()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [{"cat": e.get("cat"), "name": e.get("name"),
             "ts": float(e["ts"]), "dur": float(e["dur"])}
            for e in events if "dur" in e and "ts" in e]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without `void`, anonymous namespaces, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    name = name.split("(")[0].split("<")[0].strip()
    return name[:width] or "unnamed"


def _top(d: Dict[str, float]) -> List[List]:
    return [[k, v * 1e-6] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def reduce_device(events: List[Dict]) -> Dict:
    """{"window_s": first device operation's start to the last one's end,
    "busy_s": the union of the device operations, "kernels": [(name,
    start_s, seconds)], "device_ops": [[name, seconds]] (the longest,
    summed by name)}. Busy never exceeds the window: both come from the
    same intervals."""
    dev = [e for e in events if e["cat"] in DEVICE_CATS]
    if not dev:
        raise RuntimeError("the trace holds no device operation")
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    w0 = min(a for a, _ in spans)
    w1 = max(b for _, b in spans)
    busy_us = sum(b - a for a, b in _union(spans))
    by_name: Dict[str, float] = {}
    kernels = []
    for e in dev:
        name = short_name(e["name"]) if e["cat"] == "kernel" else e["cat"]
        by_name[name] = by_name.get(name, 0.0) + e["dur"]
        if e["cat"] == "kernel":
            kernels.append((e["name"], e["ts"] * 1e-6, e["dur"] * 1e-6))
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "kernels": kernels, "device_ops": _top(by_name),
            "device_events": len(dev)}


def idle_gaps(events: List[Dict]) -> List[List]:
    """The segment's idle gaps, summed by the innermost host span open
    when each began (the benchmark's span and the host operation), the
    longest first: [[name, seconds]]."""
    win = [e for e in events if e["name"] == WINDOW
           and e["cat"] == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no benchmark window")
    w0 = win[0]["ts"]
    w1 = w0 + win[0]["dur"]
    busy = _union([(e["ts"], min(e["ts"] + e["dur"], w1)) for e in events
                   if e["cat"] in DEVICE_CATS and w0 <= e["ts"] <= w1])
    # one sweep over the host spans in order of their start
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e["cat"] in HOST_CATS and e["name"] != WINDOW),
                  key=lambda h: h[0])
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    active: List[Tuple[float, float, str]] = []
    nxt = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        while nxt < len(host) and host[nxt][0] <= a:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] > a]
        bench = [h for h in active if h[2].startswith("bench.")]
        ops = [h for h in active if not h[2].startswith("bench.")]
        parts = []
        if bench:
            parts.append(max(bench, key=lambda h: h[0])[2])
        if ops:
            parts.append(max(ops, key=lambda h: (h[0], -h[1]))[2])
        name = "/".join(parts) or "outside any host span"
        gaps[name] = gaps.get(name, 0.0) + (b - a)
    return _top(gaps)
