#!/usr/bin/env python3
"""What one call of a kernel wrapper costs on the host, for the port.

    python3 scripts/profile_torch_launch_overhead.py [--calls 2000]
        [--rounds 7] [--report PATH]

The port's kernels are bound with ctypes, and a wrapper does its checks,
its allocation and its launch in Python; the C entry makes the integer
work (the copy granule, the tile, the size limits). For a small gather
(256 rows of 3 floats from each of 8 scenes, the kps gather of a batch)
the kernel runs for microseconds, so back-to-back calls are bound by the
host. This script times, over `--calls` calls each ending without a
synchronisation, the whole `gather_rows` call with an int32 and with an
int64 index beside `torch.gather` on the same rows, the whole
`batched_linear_sum_assignment` call at a training step's matcher shape
(56 x (132, 256), 6 valid rows), and the gather wrapper's parts on their
own: the checks, the index operand, the output allocation in six forms
(positional sizes with the source's device, an ordinal or a device object
made once; a tuple with the device or an ordinal; `new_empty`;
`empty_like` of a one-element tensor expanded to the shape), the stream
lookup, the packing of the arguments into one buffer and the ctypes call
of the packed entry that launches the kernel (the device is made current
inside the C entry, only when it is not), the same call for an empty
batch (the C entry returns before it launches: the ctypes call alone),
and `launch()` whole, which every wrapper calls; the typed entry called
with its arguments through ctypes is timed beside it. Every part runs in rounds of `--calls` calls, the parts taking turns, and the
median round is reported. Prints one JSON object (also written to
`--report PATH` when given) with the card's name and power limit, times
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
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--report", default=None,
                    help="also write the JSON result to this path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_launch_overhead: no CUDA device",
              file=sys.stderr)
        return 2

    from butd_detr_tpu_torch.ops import (
        _cuda,
        batched_linear_sum_assignment,
        gather_rows,
    )
    from butd_detr_tpu_torch.ops import gather as G

    _cuda.build_all()
    B, N, M, C = 8, 1024, 256, 3
    src = torch.randn(B, N, C, device="cuda")
    idx = torch.randint(0, N, (B, M), device="cuda", dtype=torch.int32)
    idx64 = idx.long()
    wide = idx64[..., None].expand(-1, -1, C)
    out = torch.empty(B, M, C, device="cuda")
    cost = torch.rand(56, 256, 132, device="cuda").transpose(1, 2)
    n_valid = torch.full((56,), 6, device="cuda")
    dev = src.get_device()
    launch_fn = _cuda.lib("gather").gather_launch
    _, packed_fn, layout, buf, address = _cuda._packed("gather_launch")
    raw_stream = torch._C._cuda_getCurrentRawStream
    stream = raw_stream(dev)
    row_bytes = C * 4
    kept_device = src.device
    # a one-element tensor seen as (B, M, C): empty_like gives it
    # contiguous storage of its own
    expanded = torch.empty((), device="cuda").expand(B, M, C)

    parts = {
        "gather_rows_int32": lambda: gather_rows(src, idx),
        "gather_rows_int64": lambda: gather_rows(src, idx64),
        "torch.gather": lambda: torch.gather(src, 1, wide),
        "assignment_call": lambda: batched_linear_sum_assignment(cost,
                                                                 n_valid),
        "checks": lambda: (src.is_cuda, src.shape, idx.shape, src.dtype,
                           src.is_contiguous(), src.get_device(), idx.dtype,
                           idx.get_device(), idx.is_contiguous()),
        "index_operand": lambda: G.index_operand(idx64, dev),
        "output_allocation": lambda: torch.empty(B, M, C, dtype=src.dtype,
                                                 device=src.device),
        "allocation_from_tuple": lambda: torch.empty((B, M, C),
                                                     dtype=src.dtype,
                                                     device=src.device),
        "allocation_by_ordinal": lambda: torch.empty((B, M, C),
                                                     dtype=src.dtype,
                                                     device=dev),
        "allocation_new_empty": lambda: src.new_empty((B, M, C)),
        "allocation_positional_ordinal": lambda: torch.empty(
            B, M, C, dtype=src.dtype, device=dev),
        "allocation_positional_kept_device": lambda: torch.empty(
            B, M, C, dtype=src.dtype, device=kept_device),
        "allocation_empty_like_expanded": lambda: torch.empty_like(
            expanded),
        "stream_lookup": lambda: raw_stream(dev),
        "pack_arguments": lambda: layout.pack_into(
            buf, 0, dev, src.data_ptr(), idx.data_ptr(), 0, out.data_ptr(),
            B, N, M, row_bytes, stream),
        "packed_ctypes_call": lambda: packed_fn(address),
        "typed_ctypes_call": lambda: launch_fn(
            dev, src.data_ptr(), idx.data_ptr(), 0, out.data_ptr(), B, N, M,
            row_bytes, stream),
        "launch_helper": lambda: _cuda.launch(
            "gather_launch", dev, src.data_ptr(), idx.data_ptr(), 0,
            out.data_ptr(), B, N, M, row_bytes),
        "no_launch_packed_call": lambda: (
            layout.pack_into(buf, 0, dev, src.data_ptr(), idx.data_ptr(), 0,
                             out.data_ptr(), 0, N, M, row_bytes, stream),
            packed_fn(address)),
    }
    result = {"calls": args.calls, "rounds": args.rounds,
              "shape": dict(B=B, N=N, M=M, C=C), "host_us_per_call": {}}
    rounds = {name: [] for name in parts}
    for fn in parts.values():
        for _ in range(50):
            fn()
    torch.cuda.synchronize()
    for _ in range(args.rounds):
        for name, fn in parts.items():
            t = time.perf_counter()
            for _ in range(args.calls):
                fn()
            rounds[name].append((time.perf_counter() - t) / args.calls * 1e6)
            torch.cuda.synchronize()
    for name, us in rounds.items():
        result["host_us_per_call"][name] = sorted(us)[len(us) // 2]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    result["card"] = smi.stdout.strip().splitlines()[0]
    us = result["host_us_per_call"]
    result["ratio_to_torch_gather"] = {
        k: us[k] / us["torch.gather"] for k in ("gather_rows_int32",
                                                "gather_rows_int64")}
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
