"""What the per-layer metric readers (`benchmark/metrics/<name>.py`) share:
each reader picks the quantity of its layer from a `cell.Run`, and returns
None where the run holds nothing for it to read (another kind of cell, or
no traced segment), so that the harness leaves the metric out."""

from typing import Optional

from benchmark.harness import roofline


def host_ms(run, span: str, mode: str) -> Optional[float]:
    """The mean of a benchmark span over every call of the window, in ms."""
    values = run.spans.get(span, [])
    if run.mode != mode or not values:
        return None
    return 1e3 * sum(values) / len(values)


def step_mfu(run, mode: str) -> Optional[float]:
    """The operations the window's scenes need (`flops.scene_flops`) over
    the window's seconds, as a share of the bf16 peak of the run's chips,
    in %."""
    if run.mode != mode or run.window_s <= 0 or run.scenes == 0:
        return None
    return 100.0 * run.scenes * run.flops_per_scene / run.window_s \
        / (roofline.PEAK_FLOPS * run.chips)


def kernels_roofline(run, mode: str) -> Optional[float]:
    """Sum over the kernel functions of their least time at the shapes the
    traced steps launched, over the device time the trace gives the kernels
    that implement them, in %."""
    if run.mode != mode or run.trace is None:
        return None
    bound = device = 0.0
    for fn, (share, t) in function_shares(run).items():
        bound += share * t / 100.0
        device += t
    return None if device == 0 else 100.0 * bound / device


def function_shares(run):
    """{function: (% of its roofline, device seconds)} over the traced
    steps."""
    out = {}
    if run.trace is None:
        return out
    for fn, seconds in run.bounds.items():
        t = sum(d for name, _, d in run.trace["kernels"]
                if roofline.matches(name, run.patterns[fn]))
        if t > 0:
            out[fn] = (100.0 * seconds * run.trace_steps / t, t)
    return out


def idle_share(run, mode: str) -> Optional[float]:
    """The share of the traced segment that the union of the device's
    operations (kernels, copies, sets) does not cover, in %, from the
    device's own trace alone. Unclamped: the union lies inside the segment
    by construction, so a reading outside 0-100 is a fault."""
    if run.mode != mode or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def collective_ms(run, mode: str) -> Optional[float]:
    """The device-ms a traced step spends in NCCL's kernels (a kernel that
    waits for a slower rank counts while it waits). On several GPUs the
    run's trace is rank 0's, every rank traced alike."""
    if run.mode != mode or run.trace is None:
        return None
    t = sum(d for name, _, d in run.trace["kernels"]
            if "nccl" in name.lower())
    return 1e3 * t / run.trace_steps if t > 0 else None
