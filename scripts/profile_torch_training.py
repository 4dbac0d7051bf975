#!/usr/bin/env python3
"""Where a training step's time goes on the GPU, for the port.

    python3 scripts/profile_torch_training.py [--seed 0] [--batch 8]
        [--steps 5] [--report PATH]

Builds the full-width SR3D butd_cls `Trainer` of butd_detr_tpu_torch on
`cuda` with seeded random weights and synthetic batches (as chip_smoke.py
does), warms it up, then:
  * times `--steps` whole `train_step`s on the host clock (each ends in one
    copy of the metrics to the host);
  * runs 3 more steps stage by stage (copy the batch in, forward, loss with
    the host matcher, backward, clip + optimizer), the device synchronized
    between stages: host ms per stage, and the matcher's share of the loss
    stage (cost matrices, the copy to the host, scipy's solver, the copy
    back);
  * runs 3 such staged steps again under torch.profiler: device kernel ms
    per stage by kernel group (the port's CUDA kernels, matrix products,
    the rest), and the device's busy and idle share of a whole step.
Prints one JSON object (also written to `--report PATH` when given) with
the card's name and power limit. Needs one NVIDIA GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GROUPS = (
    ("fps", "fps_"),  # fps_resident_kernel, fps_scratch_kernel
    ("ball_query", "ball_query_"),  # the scan and grid kernels
    ("attention", "attention_fwd_"),  # the _mma_ and _f32_ kernels
    ("attention_bwd", "attention_bwd_"),
    ("scatter", "scatter_rows_add_"),
    ("group_gather", "group_gather_kernel"),
    ("gather", "gather_rows_kernel"),
    ("matmul", ("gemm", "sgemm", "cutlass", "gemv", "xmma", "nvjet")),
)
STAGES = ("to_device", "forward", "loss", "backward", "optimizer")


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
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--report", default=None,
                    help="also write the JSON result to this path")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_torch_training: no CUDA device", file=sys.stderr)
        return 2

    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.data import synthetic_batch
    from butd_detr_tpu_torch.lang import roberta_base_config
    from butd_detr_tpu_torch.losses import criterion, matcher
    from butd_detr_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = butd_cls_config()
    roberta = roberta_base_config()
    trainer = Trainer(cfg, steps_per_epoch=1000, roberta_config=roberta,
                      device="cuda", seed=args.seed)

    def batch(i):
        return synthetic_batch(
            batch_size=args.batch, num_points=cfg.num_points,
            max_text_len=cfg.max_text_len, max_num_obj=cfg.max_num_obj,
            max_det_boxes=cfg.max_det_boxes, seed=args.seed + i,
            vocab_size=roberta.vocab_size, spatial_sort=cfg.spatial_sort)

    n_prof = 3
    batches = [batch(i) for i in range(2 + args.steps + 2 * n_prof)]
    for b in batches[:2]:
        trainer.train_step(b)
    torch.cuda.synchronize()
    step_ms = []
    for b in batches[2:2 + args.steps]:
        t = time.perf_counter()
        trainer.train_step(b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)

    # the matcher's host time inside the loss stage, and scipy's inside it
    clock = {"matcher": 0.0, "solver": 0.0}

    def timed(fn, key, sync):
        def wrapper(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            clock[key] += (time.perf_counter() - t) * 1e3
            return out
        return wrapper

    criterion.hungarian_match = timed(matcher.hungarian_match, "matcher",
                                      True)
    matcher.linear_sum_assignment_host = timed(
        matcher.linear_sum_assignment_host, "solver", False)

    host_ms = dict.fromkeys(STAGES, 0.0)

    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with record_function(f"stage:{name}"):
            out = fn()
            torch.cuda.synchronize()
        host_ms[name] += (time.perf_counter() - t) * 1e3
        return out

    def staged_steps(some):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in some:
            on_device = stage("to_device", lambda: trainer.to_device(b))
            trainer.begin_step()
            end_points = stage("forward",
                               lambda: trainer.forward(on_device))
            loss, end_points = stage("loss",
                                     lambda: trainer.loss(end_points))
            stage("backward", loss.backward)
            stage("optimizer", trainer.apply_gradients)
        return (time.perf_counter() - t) * 1e3 / len(some)

    first = 2 + args.steps
    staged_ms = staged_steps(batches[first:first + n_prof])
    result_host = {s: v / n_prof for s, v in host_ms.items()}
    result_clock = {k: v / n_prof for k, v in clock.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = staged_steps(batches[first + n_prof:])

    # a device kernel belongs to the stage whose host range holds its start
    # (the device is synchronized at both ends of every stage)
    events = list(prof.events())
    # the profiler mirrors host ranges (record_function, the optimizer's)
    # onto the device's timeline: they are no kernels
    host_names = {e.name for e in events
                  if e.device_type != torch.autograd.DeviceType.CUDA}
    spans = sorted((e.time_range.start, e.time_range.end, e.name[6:])
                   for e in events if e.name.startswith("stage:")
                   and e.device_type != torch.autograd.DeviceType.CUDA)
    by_stage = {s: {} for s in STAGES}
    kernels = {}
    unplaced_ms = 0.0
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name in host_names:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3 / n_prof
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
        print("profile_torch_training: the profiler recorded no device "
              "time", file=sys.stderr)
        return 1
    groups = {}
    for v in by_stage.values():
        for g, ms in v.items():
            groups[g] = groups.get(g, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:14]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    step_ms.sort()
    median_ms = step_ms[len(step_ms) // 2]
    result = {
        "card": smi.stdout.strip().splitlines()[0],
        "batch": args.batch,
        "steps": args.steps,
        "step_ms_median": median_ms,
        "step_ms_all": step_ms,
        "scenes_per_s": args.batch / median_ms * 1e3,
        "staged_wall_ms_per_step": staged_ms,
        "staged_and_profiled_wall_ms_per_step": profiled_ms,
        "host_ms_by_stage": result_host,
        "matcher_ms_in_loss": result_clock["matcher"],
        "solver_ms_in_matcher": result_clock["solver"],
        "device_ms_by_stage": {s: sum(v.values())
                               for s, v in by_stage.items()},
        "device_ms_by_stage_and_group": by_stage,
        "device_ms_by_group": groups,
        "device_ms_outside_stages": unplaced_ms,
        "device_busy_ms_per_step": busy_ms,
        # of a whole (unstaged, unprofiled) step
        "device_idle_share": max(0.0, 1.0 - busy_ms / median_ms),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "top_kernels": [dict(name=k[:90], ms=ms, per_step=c / n_prof)
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
