#!/usr/bin/env python3
"""Where an evaluation epoch's time goes on the GPU, for the port.

    python3 scripts/profile_torch_eval.py [--seed 0] [--batch 8]
        [--scenes 40] [--epochs 3] [--report PATH]

Builds the full-width SR3D butd_cls model of butd_detr_tpu_torch on `cuda`
with seeded random weights and runs `TrainTester.evaluate_one_epoch` over
`--scenes` synthetic scenes (40 at B = 8: five full batches) through the
harness's `get_datasets` seam, as chip_smoke.py does. After one warm-up
epoch:
  * times `--epochs` whole epochs on the host clock (scenes/s, ms a batch);
  * runs one more epoch with the device synchronized around its two device
    stages, `step` (`Trainer.eval_step`: copy the batch in, forward) and
    `evaluate` (`GroundingGTEvaluator.evaluate`: 14 scoring programs and
    one copy back); what is left of the epoch is `load` (the dataset and
    the collation, on the host);
  * runs such a staged epoch again under torch.profiler: device kernel ms
    per stage by kernel group (the port's CUDA kernels, matrix products,
    the rest), and the device's busy and idle share of a whole epoch.
Prints one JSON object (also written to `--report PATH` when given) with
the card's name and power limit. Needs one NVIDIA GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GROUPS = (
    ("fps", "fps_"),  # fps_resident_kernel, fps_scratch_kernel
    ("ball_query", "ball_query_"),  # the scan and grid kernels
    ("attention", "attention_fwd_"),  # the _mma_ and _f32_ kernels
    ("group_gather", "group_gather_kernel"),
    ("gather", "gather_rows_kernel"),
    ("matmul", ("gemm", "sgemm", "cutlass", "gemv", "xmma", "nvjet")),
)
STAGES = ("step", "evaluate")


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        keys = (keys,) if isinstance(keys, str) else keys
        if any(k in name.lower() for k in keys):
            return group
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--scenes", type=int, default=40)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--report", default=None,
                    help="also write the JSON result to this path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_eval: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="profile_eval_") as log_dir:
        return run(args, log_dir)


def run(args, log_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.data import SyntheticGroundingDataset
    from butd_detr_tpu_torch.eval import GroundingGTEvaluator
    from butd_detr_tpu_torch.lang import roberta_base_config
    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.train import TrainTester

    torch.backends.cuda.matmul.allow_tf32 = False
    roberta = roberta_base_config()
    cfg = butd_cls_config(batch_size=args.batch, num_workers=0,
                          rng_seed=args.seed, log_dir=log_dir)
    scenes = SyntheticGroundingDataset(
        args.scenes, seed=args.seed + 1000, num_points=cfg.num_points,
        max_text_len=cfg.max_text_len, max_num_obj=cfg.max_num_obj,
        max_det_boxes=cfg.max_det_boxes, vocab_size=roberta.vocab_size,
        spatial_sort=cfg.spatial_sort)

    class Tester(TrainTester):
        def get_datasets(self):
            return scenes, scenes

    tester = Tester(cfg, device="cuda")
    _, loader = tester.get_loaders()
    trainer = tester.get_trainer(len(loader))
    n_batches = len(loader)

    def epoch():
        torch.cuda.synchronize()
        t = time.perf_counter()
        tester.evaluate_one_epoch(1, loader, trainer)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    epoch()  # warm-up: handles, allocator
    _cuda.reset_launches()
    epoch_ms = [epoch() for _ in range(args.epochs)]
    launches = {k: v / args.epochs / n_batches
                for k, v in _cuda.LAUNCHES.items()}

    host_ms = dict.fromkeys(STAGES, 0.0)

    def staged(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with record_function(f"stage:{name}"):
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            host_ms[name] += (time.perf_counter() - t) * 1e3
            return out
        return wrapper

    trainer.eval_step = staged("step", trainer.eval_step)
    GroundingGTEvaluator.evaluate = staged("evaluate",
                                           GroundingGTEvaluator.evaluate)
    staged_ms = epoch()
    result_host = {s: v / n_batches for s, v in host_ms.items()}
    result_host["load"] = staged_ms / n_batches - sum(result_host.values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = epoch()

    # a device kernel belongs to the stage whose host range holds its start
    # (the device is synchronized at both ends of every stage); the profiler
    # mirrors host ranges onto the device's timeline: they are no kernels
    events = list(prof.events())
    on_device = torch.autograd.DeviceType.CUDA
    host_names = {e.name for e in events if e.device_type != on_device}
    spans = sorted((e.time_range.start, e.time_range.end, e.name[6:])
                   for e in events if e.name.startswith("stage:")
                   and e.device_type != on_device)
    by_stage = {s: {} for s in STAGES}
    kernels = {}
    unplaced_ms = 0.0
    for e in events:
        if e.device_type != on_device or e.name in host_names:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3 / n_batches
        if ms <= 0:
            continue
        start = e.time_range.start
        name = next((s for lo, hi, s in spans if lo <= start <= hi), None)
        if name is None:
            unplaced_ms += ms
            continue
        g = group_of(e.name)
        by_stage[name][g] = by_stage[name].get(g, 0.0) + ms
        k_ms, k_n = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (k_ms + ms, k_n + 1)
    busy_ms = sum(sum(v.values()) for v in by_stage.values()) + unplaced_ms
    if busy_ms <= 0:
        print("profile_torch_eval: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    groups = {}
    for v in by_stage.values():
        for g, ms in v.items():
            groups[g] = groups.get(g, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:14]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    epoch_ms.sort()
    median_ms = epoch_ms[len(epoch_ms) // 2]
    batch_ms = median_ms / n_batches
    result = {
        "card": smi.stdout.strip().splitlines()[0],
        "batch": args.batch,
        "scenes": args.scenes,
        "batches": n_batches,
        "epoch_ms_median": median_ms,
        "epoch_ms_all": epoch_ms,
        "batch_ms": batch_ms,
        "scenes_per_s": args.scenes / median_ms * 1e3,
        "launches_per_batch": launches,
        "staged_wall_ms_per_batch": staged_ms / n_batches,
        "staged_and_profiled_wall_ms_per_batch": profiled_ms / n_batches,
        "host_ms_by_stage": result_host,
        "device_ms_by_stage": {s: sum(v.values())
                               for s, v in by_stage.items()},
        "device_ms_by_stage_and_group": by_stage,
        "device_ms_by_group": groups,
        "device_ms_outside_stages": unplaced_ms,
        "device_busy_ms_per_batch": busy_ms,
        # of a whole (unstaged, unprofiled) epoch
        "device_idle_share": max(0.0, 1.0 - busy_ms / batch_ms),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "top_kernels": [dict(name=k[:90], ms=ms, per_batch=c / n_batches)
                        for k, (ms, c) in top],
    }
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
