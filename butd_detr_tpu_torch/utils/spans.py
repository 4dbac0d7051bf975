"""Stage spans and the read-back counter of the program's steps.

`span(name)` marks a stage of a step (`with span("forward"): ...`).

  * Off, the default, it costs one test of a module flag: it reads no
    clock and opens no profiler range.
  * On (`enable(True)`), it records each span in memory on the host's
    monotonic clock: per name the calls, the inclusive ns and the self ns
    (inclusive less what its child spans cover), and a `Record` of every
    span with its parent's name. A root span (one opened inside no other)
    carries a step: the one its caller gives (the trainer's step for
    `train_step`), else a running count of roots; its children carry it
    too, so the spans of one step share it.
  * On, while a `torch.profiler` records, it also opens
    `torch.profiler.record_function(name)`, so that the trace holds the
    span as a host `user_annotation` on the clock that the device's records
    share: a gap of the device can be put down to the span the host was in.

The spans of the steps, from the root down:

    train_step > to_device, begin_step,
                 forward > backbone, text, encoder, decoder,
                 loss > match, backward, optimizer
    eval_step  > to_device, forward > ..., loss > match
    evaluate   > hits, readback
    readback   (wherever the program copies to the host and waits)

`count(name, n)` counts, on or off: its one counter is `readbacks`, each
device-to-host copy that blocks the host, with its bytes, at every
read-back site (`to_host`). It counts at the site on the CPU too, where
the copy costs nothing, so that a path's count is the same on any device.
Read it as `LAUNCHES` is read: `counts()` before and after.
"""

import time
from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional

import torch

# the clock of the spans (a test may replace it)
clock = time.perf_counter_ns

_on = False
_OFF = nullcontext()
_open: List["_Span"] = []
_totals: Dict[str, List[int]] = {}  # name -> [calls, ns, self ns]
_records: List["Record"] = []
_roots = 0
_counts: Dict[str, List[int]] = {"readbacks": [0, 0]}  # [calls, bytes]


class Record(NamedTuple):
    name: str
    parent: Optional[str]
    step: int
    start_ns: int
    ns: int


class _Span:
    __slots__ = ("name", "step", "parent", "start", "children", "range")

    def __init__(self, name: str, step: Optional[int]):
        self.name = name
        self.step = step

    def __enter__(self):
        global _roots
        parent = _open[-1] if _open else None
        self.parent = parent
        if parent is not None:
            self.step = parent.step
        elif self.step is None:
            _roots += 1
            self.step = _roots
        self.children = 0
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        _open.append(self)
        self.start = clock()
        return self

    def __exit__(self, *exc):
        ns = clock() - self.start
        _open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        total = _totals.setdefault(self.name, [0, 0, 0])
        total[0] += 1
        total[1] += ns
        total[2] += ns - self.children
        parent = self.parent
        if parent is not None:
            parent.children += ns
        _records.append(Record(self.name, parent and parent.name, self.step,
                               self.start, ns))
        return False


def span(name: str, step: Optional[int] = None):
    """A context manager that marks the stage `name` (see the module's
    docstring); `step` names a root span's step."""
    if not _on:
        return _OFF
    return _Span(name, step)


def enable(on: bool = True) -> bool:
    """Switch the spans on or off; returns whether they were on."""
    global _on
    was, _on = _on, bool(on)
    return was


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget the spans recorded so far (the counters keep counting)."""
    global _roots
    _totals.clear()
    _records.clear()
    _roots = 0


def totals() -> Dict[str, Dict[str, int]]:
    """{name: {"calls", "ns", "self_ns"}} of the spans closed since the
    last `reset`."""
    return {k: {"calls": c, "ns": ns, "self_ns": s}
            for k, (c, ns, s) in _totals.items()}


def records() -> List[Record]:
    """Every span closed since the last `reset`, in the order it closed."""
    return list(_records)


def count(name: str, n: int = 0) -> None:
    """Add one call, and `n` (bytes for `readbacks`), to the counter
    `name`."""
    c = _counts.setdefault(name, [0, 0])
    c[0] += 1
    c[1] += n


def counts() -> Dict[str, Dict[str, int]]:
    """{name: {"calls", "bytes"}}, counted since the process started."""
    return {k: {"calls": c, "bytes": n} for k, (c, n) in _counts.items()}


def to_host(t: torch.Tensor) -> torch.Tensor:
    """`t.cpu()` at a read-back site: in a `readback` span, counted in
    `readbacks` with its bytes."""
    with span("readback"):
        count("readbacks", t.numel() * t.element_size())
        return t.cpu()


__all__ = ["Record", "clock", "count", "counts", "enable", "enabled",
           "records", "reset", "span", "to_host", "totals"]
