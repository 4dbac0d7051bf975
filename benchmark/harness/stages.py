"""The program's stage spans in a traced run, and what they show.

Two segments of `trace_steps` steps or batches, beside the benchmark's own
traced segments, which keep the program's spans off:
`trace._device_events` counts every event on the device that is no copy
or set as a kernel unless its name starts with `bench.`, and the
breakdown's idle gaps are named by the benchmark's spans and the host's
operations alone.

(a) Before the benchmark's segments: the spans on and no profiler; per
    span name its calls, inclusive and self host ms a step, the roots'
    ms, and the read-backs a step (`reduce_spans`). It runs before any
    profiler of the run because a profiler's session leaves the host
    slower after it ends: on the H100's host the training step read
    272 host-ms before the benchmark's two profiled segments, 296 after
    them and 329-338 after two more.
(b) After the benchmark's segments: the spans on under `trace.record`;
    each idle gap of the device in the benchmark's window is put down to
    the innermost stage (`STAGES`) open on the host when it began;
    `match` counts for `loss` and `hits` for `evaluate`; the rest goes to
    `root` (inside `train_step` or `eval_step` but in no stage) or
    `outside` (in the benchmark's loop). The split by the innermost span
    of any name goes beside it (`stage_idle`). Then the same steps on the
    device alone, the spans off, for `device_annotations`.

`measure_host` and `measure_idle` run them and put their reductions on the
run as `run.stages`; `readings(run)` gives the per-stage numbers by the
names of their metrics. Only these touch the program, through its span
module.
"""

import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from benchmark.harness import trace as tr

STAGES = ("forward", "loss", "backward", "optimizer", "evaluate",
          "readback")
# spans whose idle counts for the stage around them
ROLLUP = {"match": "loss", "hits": "evaluate"}
ROOTS = ("train_step", "eval_step")
# the metric of each stage's idle, by mode
IDLE_METRICS = {"train": ("forward", "loss", "backward", "optimizer"),
                "eval": ("forward", "loss", "evaluate", "readback")}


def _program_spans():
    from butd_detr_tpu_torch.utils import spans

    return spans


def reduce_spans(totals: Dict[str, Dict[str, int]], records: List,
                 before: Dict[str, int], after: Dict[str, int],
                 steps: int) -> Dict:
    """Segment (a), a step: {"spans": {name: {"calls", "ms", "self_ms"}},
    "roots": {name: ms of the spans opened inside no other},
    "readbacks", "readback_bytes"}, from the span totals and records and
    the `readbacks` counter before and after."""
    roots: Dict[str, float] = {}
    for r in records:
        if r.parent is None:
            roots[r.name] = roots.get(r.name, 0.0) + r.ns * 1e-6 / steps
    return {
        "spans": {k: {"calls": v["calls"] / steps,
                      "ms": v["ns"] * 1e-6 / steps,
                      "self_ms": v["self_ns"] * 1e-6 / steps}
                  for k, v in sorted(totals.items())},
        "roots": roots,
        "readbacks": (after["calls"] - before["calls"]) / steps,
        "readback_bytes": (after["bytes"] - before["bytes"]) / steps}


def _innermost(spans: List) -> tuple:
    return max(spans, key=lambda h: (h[0], -h[1]))


def stage_idle(events: List[Dict], steps: int) -> Dict:
    """Segment (b): the idle gaps of the device in the benchmark's window,
    in ms a step: {"total_ms", "stages": {stage, "root", "outside": ms}
    (every stage that occurred, 0 if it held no gap), "spans": {innermost
    span or "outside": ms}}. A span is a host `user_annotation` other than
    the benchmark's; `gpu_user_annotation` events are no device work."""
    win = [e for e in events if e["name"] == tr.WINDOW
           and e["cat"] == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no benchmark window")
    w0 = win[0]["ts"]
    w1 = w0 + win[0]["dur"]
    busy = tr._union([(e["ts"], min(e["ts"] + e["dur"], w1))
                      for e in events
                      if e["cat"] in tr.DEVICE_CATS and w0 <= e["ts"] <= w1])
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e["cat"] == "user_annotation"
                   and not e["name"].startswith("bench.")),
                  key=lambda h: h[0])
    occurred = {ROLLUP.get(h[2], h[2]) for h in host if w0 <= h[0] <= w1}
    stages = {s: 0.0 for s in STAGES if s in occurred}
    stages.update(root=0.0, outside=0.0)
    by_span: Dict[str, float] = {}
    total = 0.0
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    active: List = []
    nxt = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        while nxt < len(host) and host[nxt][0] <= a:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] > a]
        gap = (b - a) * 1e-3 / steps
        total += gap
        staged = [h for h in active if h[2] in STAGES or h[2] in ROLLUP]
        if staged:
            name = _innermost(staged)[2]
            stage = ROLLUP.get(name, name)
        elif any(h[2] in ROOTS for h in active):
            stage = "root"
        else:
            stage = "outside"
        stages[stage] += gap
        name = _innermost(active)[2] if active else "outside"
        by_span[name] = by_span.get(name, 0.0) + gap
    return {"total_ms": total, "stages": stages,
            "spans": dict(sorted(by_span.items(), key=lambda kv: -kv[1]))}


def _chrome_events(prof) -> List[Dict]:
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


def device_annotations(segment: Callable[[], None]) -> Dict:
    """Run `segment` under the device-only profiler of
    `trace.device_window` and list what `trace._device_events` counts as
    device work but is no kernel, copy or set by the Chrome trace's
    categories: {"cats": {category: events}, "other": {name: [events,
    seconds]}, "busy_s": as `trace.reduce_device` reads the segment,
    "busy_s_work": with those events left out}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        segment()
        torch.cuda.synchronize()
    device = tr._device_events(prof)
    cats: Dict[str, int] = {}
    work = set()
    for e in _chrome_events(prof):
        cats[e["cat"]] = cats.get(e["cat"], 0) + 1
        if e["cat"] in tr.DEVICE_CATS:
            work.add(e["name"])
    other: Dict[str, List] = {}
    for e in device:
        if e["name"] not in work:
            n, s = other.get(e["name"], (0, 0.0))
            other[e["name"]] = [n + 1, s + e["dur"] * 1e-6]
    return {"cats": cats, "other": other,
            "busy_s": tr.reduce_device(device)["busy_s"],
            "busy_s_work": tr.reduce_device(
                [e for e in device if e["name"] in work])["busy_s"]}


def host_segment(segment: Callable[[], None], steps: int) -> Dict:
    """Segment (a): `segment` with the spans on and no profiler, reduced
    by `reduce_spans`."""
    spans = _program_spans()
    was = spans.enable(True)
    try:
        spans.reset()
        before = spans.counts()["readbacks"]
        torch.cuda.synchronize()
        segment()
        torch.cuda.synchronize()
        return reduce_spans(spans.totals(), spans.records(), before,
                            spans.counts()["readbacks"], steps)
    finally:
        spans.enable(was)


def idle_segment(segment: Callable[[], None], steps: int) -> Dict:
    """Segment (b): `segment` with the spans on under `trace.record`,
    reduced by `stage_idle`."""
    spans = _program_spans()
    was = spans.enable(True)
    try:
        return stage_idle(tr.record(segment), steps)
    finally:
        spans.enable(was)


def measure_host(run, segment) -> None:
    """Segment (a), before any profiler of the run: `run.stages` holds
    its reduction. (`segment(n)` gives the call that runs n steps.)"""
    n = run.cell["entry"]["trace_steps"]
    t0 = time.perf_counter()
    host = host_segment(segment(n), n)
    run.stages = {"steps": n, "host": host,
                  "seconds": {"a": time.perf_counter() - t0}}


def measure_idle(run, segment) -> None:
    """Segment (b), then as many steps on the device alone with the spans
    off for `device_annotations`, after the benchmark's segments; their
    reductions and seconds join `run.stages`."""
    n = run.cell["entry"]["trace_steps"]
    t0 = time.perf_counter()
    run.stages["idle"] = idle_segment(segment(n), n)
    t1 = time.perf_counter()
    run.stages["device_annotations"] = device_annotations(segment(n))
    run.stages["seconds"].update(b=t1 - t0,
                                 device_only=time.perf_counter() - t1)


def readings(run) -> Dict[str, float]:
    """The per-stage numbers of `run.stages` by their metrics' names: each
    stage's idle ms a step (segment (b)) and, in evaluation, the host ms a
    batch spent in `readback` (segment (a)); a stage that did not occur
    gives none."""
    s: Optional[Dict] = getattr(run, "stages", None)
    if s is None:
        return {}
    out = {}
    idle = s["idle"]["stages"]
    for stage in IDLE_METRICS[run.mode]:
        if stage in idle:
            out[f"{stage}_idle_ms.{run.mode}"] = idle[stage]
    wait = s["host"]["spans"].get("readback")
    if run.mode == "eval" and wait is not None:
        out["readback_wait_ms.eval"] = wait["ms"]
    return out
