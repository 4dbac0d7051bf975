"""Run one cell as `run.py` does, with the program's stage spans.

    python3 benchmark/run_stages.py --workload <cell> --seed <n> \
        --seconds <s> --trace 1
    python3 benchmark/run_stages.py --spans 1 --workload <cell> --seed <n> \
        --seconds <s> --trace 0

from the root of a checkout, on a machine with the cell's GPUs.

`--trace 1` runs the cell's traced run with the segments of
`harness/stages.py`: (a), the spans on without a profiler, before the
run's two traced segments; (b), the spans on under the host's profiler,
and one device-only segment with the spans off, after them. Before the
result line, a `stages:` line on standard error gives the spans' host ms
a step, the read-backs a step, the device's idle split by stage and by
span, the per-stage readings under their metrics' names, the seconds the
segments took, the window's host spans beside segment (a)'s roots, and
the events on the device that are no kernel, copy or set.

`--spans 1` (with `--trace 0`) runs the measured window with the spans on,
to be set beside `run.py`'s window with them off: what the spans cost.

The other arguments are `run.py`'s, and so is the result line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--spans", type=int, choices=(0, 1), default=0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args, rest = p.parse_known_args(argv)
    if args.spans and args.trace:
        p.error("--spans 1 runs an untraced window (--trace 0)")
    sys.path.insert(0, ROOT)
    from benchmark import run
    from benchmark.harness import cell, report, stages

    run.T_START = T_START
    if args.spans:
        stages._program_spans().enable(True)
    traced = cell._traced

    def with_stages(run_, segment):
        stages.measure_host(run_, segment)
        traced(run_, segment)
        stages.measure_idle(run_, segment)
        report.log("stages:", json.dumps(summary(run_)))

    cell._traced = with_stages
    return run.main(rest + ["--trace", str(args.trace)])


def summary(run_) -> dict:
    """`run.stages` with the readings and, beside segment (a)'s roots, the
    window's host spans: the step (with the losses' read-back in the det
    setup) and the evaluator, ms a step."""
    from benchmark.harness import readers, stages

    roots = run_.stages["host"]["roots"]
    if run_.mode == "train":
        step = roots.get("train_step")
    else:
        step = roots.get("eval_step", 0.0) + roots.get("readback", 0.0)
    return dict(run_.stages, readings=stages.readings(run_), window={
        "step_host_ms": readers.host_ms(run_, "step", run_.mode),
        "evaluator_host_ms": readers.host_ms(run_, "evaluate", run_.mode),
        "segment_a_step_ms": step,
        "segment_a_evaluate_ms": roots.get("evaluate")})


if __name__ == "__main__":
    sys.exit(main())
