#!/usr/bin/env python3
"""The row gather (K6) and the assignment solver (K8) alone, for the port.

    python3 scripts/profile_torch_gather_assignment.py [--rounds 3]
        [--reps 20] [--seed 0] [--kernels gather,assignment]
        [--package-root DIR] [--report PATH]

K6 (`ops.gather_rows`):
  * a call at every row shape of the main paths (chip_smoke.py phase 2:
    the four `new_xyz` gathers, the two interpolations, the kps gathers
    and the loss's matched boxes, at B = 1 and B = 8), each with the
    index type the path hands it, beside `torch.gather` on the same rows.
    A call is `--reps` back-to-back calls between two CUDA events: at
    these shapes that is the host's time a call. K6 and `torch.gather`
    take turns, shape by shape, over `--rounds` rounds; the median round
    is kept. The sum over an evaluation batch's 8 launches is reported
    for each;
  * the device time at the f32 backbone's groupings (sa2-sa4 at B = 8,
    rows of 131 and 259 f32), beside `torch.gather` and the bound (the
    index and the distinct source rows read once, the output written
    once, over 3.35 TB/s).
K8 (`ops.batched_linear_sum_assignment`): the device time of the
matcher call of each path (chip_smoke.py:ASSIGNMENT_SHAPES), and of a
training step's call (56 x (132, 256)) with 0, 1, 2, 3 and 6 valid rows in
every matrix and, where the package plans its slices, R and R + 1.

A device time is taken over `--reps` launches queued behind a spin
kernel that holds the stream until the host has queued them all
(chip_smoke.py:device_ms), so the host's time a call does not enter it.

`--package-root DIR` imports `butd_detr_tpu_torch` from DIR instead of
this checkout, so that one copy of the script times two trees (the parent
and a change) on one card in turns. Prints one JSON object (also written
to `--report PATH`) with the card's name and power limit; times in ms.
Needs one NVIDIA GPU.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, source rows n, channels C, rows M, dtype, index dtype, launches
# an evaluation batch): the row gathers of a request and of an evaluation
# batch, chip_smoke.py:forward_gathers
ROW_SHAPES = [
    ("sa1_new_xyz", 50000, 3, 2048, "float32", "int32", 1),
    ("sa2_new_xyz", 2048, 3, 1024, "float32", "int32", 1),
    ("sa3_new_xyz", 1024, 3, 512, "float32", "int32", 1),
    ("sa4_new_xyz", 512, 3, 256, "float32", "int32", 1),
    ("fp1_interpolate", 256, 256, 1536, "bfloat16", "int32", 1),
    ("fp2_interpolate", 512, 256, 3072, "bfloat16", "int32", 1),
    ("kps_xyz", 1024, 3, 256, "float32", "int32", 1),
    ("kps_features", 1024, 288, 256, "float32", "int32", 1),
    ("matched_boxes", 256, 6, 132, "float32", "int64", 0),
]
# the f32 backbone's groupings (--no-backbone_bf16): (B, n, C, m * ns)
GROUPINGS = [
    ("sa2_group_f32", 2048, 131, 1024 * 32),
    ("sa3_group_f32", 1024, 259, 512 * 16),
    ("sa4_group_f32", 512, 259, 256 * 16),
]
HBM_BYTES_PER_S = 3.35e12


def distinct_rows(idx, n):
    import torch

    seen = torch.zeros(idx.shape[0], n, dtype=torch.bool, device=idx.device)
    seen.scatter_(1, idx.long(), True)
    return int(seen.sum())


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def gather_calls(args, gen):
    """K6 and torch.gather a call, in turns, at the main paths' rows."""
    import torch

    from chip_smoke import time_ms
    from butd_detr_tpu_torch.ops import gather_rows

    cases = []
    for B in (1, 8):
        for name, n, C, M, dt, it, per_batch in ROW_SHAPES:
            src = torch.randn(B, n, C, device="cuda", generator=gen).to(
                getattr(torch, dt))
            idx = torch.randint(0, n, (B, M), device="cuda", generator=gen
                                ).to(getattr(torch, it))
            wide = idx.long()[..., None].expand(-1, -1, C)
            cases.append(dict(name=name, B=B, n=n, C=C, M=M, dtype=dt,
                              index_dtype=it, per_batch=per_batch,
                              k6=lambda s=src, i=idx: gather_rows(s, i),
                              lib=lambda s=src, w=wide: torch.gather(s, 1,
                                                                     w)))
    rounds = {i: dict(k6=[], lib=[]) for i in range(len(cases))}
    for _ in range(args.rounds):
        for i, c in enumerate(cases):
            rounds[i]["k6"].append(time_ms(c["k6"], args.reps))
            rounds[i]["lib"].append(time_ms(c["lib"], args.reps))
    rows, totals = [], {}
    for i, c in enumerate(cases):
        ms, lms = _median(rounds[i]["k6"]), _median(rounds[i]["lib"])
        rows.append({k: c[k] for k in ("name", "B", "n", "C", "M", "dtype",
                                       "index_dtype", "per_batch")}
                    | dict(ms=ms, library_ms=lms, ms_rounds=rounds[i]["k6"],
                           library_ms_rounds=rounds[i]["lib"]))
        for key, val in ((f"b{c['B']}_ms", ms), (f"b{c['B']}_library_ms",
                                                  lms)):
            totals[key] = totals.get(key, 0.0) + c["per_batch"] * val
        print(f"K6 {c['name']:16s} B={c['B']} ({c['n']}, {c['C']}) "
              f"{c['dtype']} M {c['M']} {c['index_dtype']}: {ms * 1e3:.2f} "
              f"us a call, torch.gather {lms * 1e3:.2f}", flush=True)
    print(f"K6 8 launches: B = 1 {totals['b1_ms']:.4f} ms (torch.gather "
          f"{totals['b1_library_ms']:.4f}), B = 8 {totals['b8_ms']:.4f} "
          f"({totals['b8_library_ms']:.4f})", flush=True)
    return rows, totals


def gather_groupings(args, gen):
    """K6's and torch.gather's device ms at the f32 groupings (B = 8)."""
    import torch

    from chip_smoke import device_ms
    from butd_detr_tpu_torch.ops import gather_rows

    rows = []
    B = 8
    for name, n, C, M in GROUPINGS:
        src = torch.randn(B, n, C, device="cuda", generator=gen)
        idx = torch.randint(0, n, (B, M), device="cuda", generator=gen,
                            dtype=torch.int32)
        wide = idx.long()[..., None].expand(-1, -1, C)
        nbytes = (B * M * 4 + (distinct_rows(idx, n) + B * M) * C * 4)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        turns = dict(k6=[], lib=[])
        for _ in range(args.rounds):
            turns["k6"].append(device_ms(lambda: gather_rows(src, idx),
                                         args.reps))
            turns["lib"].append(device_ms(lambda: torch.gather(src, 1, wide),
                                          args.reps))
        ms, lms = _median(turns["k6"]), _median(turns["lib"])
        rows.append(dict(name=name, B=B, n=n, C=C, M=M, device_ms=ms,
                         library_device_ms=lms, bound_ms=bound,
                         device_ms_rounds=turns["k6"],
                         library_device_ms_rounds=turns["lib"]))
        print(f"K6 {name} (8, {n}, {C}) f32 M {M}: device {ms:.4f} ms, "
              f"torch.gather {lms:.4f}, bound {bound:.4f} "
              f"({ms / bound:.2f}x)", flush=True)
        del src, idx, wide
    return rows


def assignment_times(args, gen):
    """K8's device ms at each path's matcher call and at R, R + 1 rows."""
    import torch

    from chip_smoke import ASSIGNMENT_SHAPES, device_ms, matcher_costs
    from butd_detr_tpu_torch.ops import batched_linear_sum_assignment
    from butd_detr_tpu_torch.ops import assignment as A

    rows = []
    cases = []
    for name, M, G, Q, counts in ASSIGNMENT_SHAPES:
        pick = torch.randint(0, len(counts), (M,), device="cuda",
                             generator=gen)
        cases.append((name, M, G, Q,
                      torch.tensor(counts, device="cuda")[pick]))
    # the cost of a valid row: every matrix of a training step's call with
    # 0 to 6 valid rows, then R and R + 1 (the rows the kernel stages)
    counts = [0, 1, 2, 3, 6]
    plan = getattr(A, "assignment_plan", None)
    if plan is not None:
        R = plan(132, 256)["rows_staged"]
        counts += [R, R + 1]
    for n in counts:
        cases.append((f"training_n{n}", 56, 132, 256,
                      torch.full((56,), n, device="cuda")))
    for name, M, G, Q, n_valid in cases:
        cost = matcher_costs(gen, M, G, Q, n_valid)
        turns = [device_ms(lambda: batched_linear_sum_assignment(
            cost, n_valid), args.reps) for _ in range(args.rounds)]
        ms = _median(turns)
        rows.append(dict(name=name, matrices=M, targets=G, queries=Q,
                         rows=int(n_valid.sum()), device_ms=ms,
                         device_ms_rounds=turns))
        print(f"K8 {name}: {M} x ({G}, {Q}), {int(n_valid.sum())} rows: "
              f"device {ms * 1e3:.2f} us", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="gather,assignment",
                    help="which of gather, assignment to time")
    ap.add_argument("--package-root", default=ROOT,
                    help="directory holding the butd_detr_tpu_torch to time")
    ap.add_argument("--report", default=None,
                    help="also write the JSON result to this path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_gather_assignment: no CUDA device",
              file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.abspath(args.package_root), ROOT]
    from butd_detr_tpu_torch.ops import _cuda

    _cuda.build_all()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"package": os.path.abspath(args.package_root),
              "rounds": args.rounds, "reps": args.reps}
    kernels = args.kernels.split(",")
    if "gather" in kernels:
        result["gather_calls"], result["gather_totals"] = gather_calls(args,
                                                                       gen)
        result["gather_groupings"] = gather_groupings(args, gen)
    if "assignment" in kernels:
        result["assignment"] = assignment_times(args, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    result["card"] = smi.stdout.strip().splitlines()[0]
    print(result["card"])
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
