"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA GPUs. The
last line of standard output is one JSON object (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` `breakdown`, and last
`checks`: every number compared beside its limit, which also end standard
error). `--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics. `--control 1` runs the program's lower-precision path
(`--use_bf16`) and `--fault <name>` plants a fault (see
`harness/program.py`): both exist to show that the check fails them.
A cell on several GPUs runs one process a GPU (`harness/ranks.py`), which
this process starts, watches and ends; it prints the result.

Build and compile caches stay inside the checkout: the port builds its
kernels into `butd_detr_tpu_torch/_build/`, and Triton and PyTorch's
extension builds are pointed at `benchmark/_cache/`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, "_cache")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness import report, spec

    cell = spec.load_cell(args.workload)
    chips = cell["bench"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        report.log(f"{args.workload} needs {chips} CUDA device(s); "
                   f"{torch.cuda.device_count()} available")
        return 2
    torch.set_num_threads(4)
    if chips > 1:
        from benchmark.harness import ranks

        try:
            res = ranks.run_cell_ranks(
                cell, args.seed, args.seconds, bool(args.trace),
                device="cuda", control=bool(args.control), fault=args.fault,
                t_start=T_START)
        except ranks.RanksFailed as e:
            report.log(f"{args.workload}: {e}; no result")
            return 1
    else:
        res = cells.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             device="cuda", control=bool(args.control),
                             fault=args.fault, t_start=T_START)
    line = report.result(cell, res, bool(args.trace), "cuda")
    report.earlier_lines(res, "cuda")
    found = sorted(set(report.forbidden_modules())
                   | set(res.get("forbidden", [])))
    if found:
        report.log(f"the run loaded {found}; no result")
        return 3
    report.check_lines(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
