#!/usr/bin/env python3
"""What one call of a kernel wrapper costs on the host, for the port.

    python3 scripts/profile_torch_launch_overhead.py [--calls 3000]
        [--report PATH]

The port's kernels are bound with ctypes, and a wrapper does its checks,
its allocation and its launch in Python. For a small gather (256 rows of 3
floats from each of 8 scenes, the kps gather of a batch) the kernel runs
for microseconds, so back-to-back calls are bound by the host. This script
times, over `--calls` calls each ending without a synchronisation, the
whole `gather_rows` call beside `torch.gather` on the same rows, and the
wrapper's parts on their own: the device context, the stream lookup, the
output allocation, the index and layout checks, the unit choice, and the
ctypes call that launches the kernel. Prints one JSON object (also written
to `--report PATH` when given) with the card's name and power limit, times
in microseconds a call. Needs one NVIDIA GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=3000)
    ap.add_argument("--report", default=None,
                    help="also write the JSON result to this path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_launch_overhead: no CUDA device",
              file=sys.stderr)
        return 2

    from butd_detr_tpu_torch.ops import _cuda, gather_rows
    from butd_detr_tpu_torch.ops import gather as G

    _cuda.build_all()
    B, N, M, C = 8, 1024, 256, 3
    src = torch.randn(B, N, C, device="cuda")
    idx = torch.randint(0, N, (B, M), device="cuda", dtype=torch.int32)
    wide = idx.long()[..., None].expand(-1, -1, C)
    out = torch.empty(B, M, C, device="cuda")
    lib = _cuda.lib("gather")
    stream = _cuda.stream_of(src)

    def device_context():
        with torch.cuda.device(src.device):
            pass

    parts = {
        "gather_rows": lambda: gather_rows(src, idx),
        "torch.gather": lambda: torch.gather(src, 1, wide),
        "device_context": device_context,
        "stream_lookup": lambda: _cuda.stream_of(src),
        "output_allocation": lambda: torch.empty(B, M, C, device=src.device),
        "index_cast_check": lambda: G._index(idx, src.device),
        "shape_and_layout_checks": lambda: (
            G._check(src, idx, 2, "gather_rows"),
            G._payload(src).contiguous()),
        "unit_choice": lambda: G._units(src, out),
        "ctypes_launch": lambda: lib.gather_launch(
            _cuda.ptr(src), _cuda.ptr(idx), _cuda.ptr(out), B, N, M, C, 4,
            stream),
    }
    result = {"calls": args.calls, "shape": dict(B=B, N=N, M=M, C=C),
              "host_us_per_call": {}}
    for name, fn in parts.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(args.calls):
            fn()
        result["host_us_per_call"][name] = (
            (time.perf_counter() - t) / args.calls * 1e6)
        torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    result["card"] = smi.stdout.strip().splitlines()[0]
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
