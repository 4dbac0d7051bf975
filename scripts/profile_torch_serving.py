#!/usr/bin/env python3
"""Where a serving request's time goes on the GPU, for the port.

    python3 scripts/profile_torch_serving.py [--seed 0] [--requests 20]
        [--report PATH]

Builds the full-width SR3D butd_cls GroundingPredictor of
butd_detr_tpu_torch on `cuda` with seeded random weights (as chip_smoke.py
does), warms it up, then:
  * times `--requests` requests on the host clock (each ends in a copy to
    the host): median and p90 latency;
  * splits one request into host input preparation, the model forward
    (synchronized) and the scoring;
  * profiles 3 requests with torch.profiler: device kernel time by kernel
    and by group (the port's CUDA kernels, matrix products, the rest), and
    the device's busy and idle share of the wall time.
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
    ("group_gather", "group_gather_kernel"),
    ("gather", "gather_rows_kernel"),
    ("matmul", ("gemm", "sgemm", "cutlass", "gemv", "xmma", "nvjet")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        keys = (keys,) if isinstance(keys, str) else keys
        if any(k in name.lower() for k in keys):
            return group
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--report", default=None,
                    help="also write the JSON result to this path")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import REQUESTS, make_scene

    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.predict import (
        NUM_BINS,
        GroundingPredictor,
        contrast_scores,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = butd_cls_config()
    pred = GroundingPredictor(cfg, device="cuda", seed=args.seed)
    rng = np.random.RandomState(args.seed)
    scenes = [make_scene(rng) for _ in range(4)]

    def request(i):
        cloud, boxes, cids = scenes[i % len(scenes)]
        utt, phrase = REQUESTS[i % len(REQUESTS)]
        return pred.predict(cloud, utt, phrase=phrase, det_boxes=boxes,
                            det_class_ids=cids, top_k=10)

    for i in range(3):
        request(i)
    lat = []
    for i in range(args.requests):
        t = time.perf_counter()
        request(i)
        lat.append((time.perf_counter() - t) * 1e3)
    lat.sort()

    # one request split into its stages
    cloud, boxes, cids = scenes[0]
    utt = REQUESTS[0][0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inputs = pred.make_inputs(cloud, utt, boxes, cids)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.inference_mode():
        ep = pred.model(inputs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        contrast_scores(ep, "last_", NUM_BINS).cpu()
    t3 = time.perf_counter()
    stages = {"prepare_inputs_ms": (t1 - t0) * 1e3,
              "forward_ms": (t2 - t1) * 1e3, "scoring_ms": (t3 - t2) * 1e3}

    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(n_prof):
            request(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / n_prof
    kernels = {}
    launches = 0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels[evt.key] = (dev_us / 1e3 / n_prof, evt.count // n_prof)
        launches += evt.count
    busy_ms = sum(ms for ms, _ in kernels.values())
    groups = {}
    for name, (ms, _) in kernels.items():
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    result = {
        "card": smi.stdout.strip().splitlines()[0],
        "requests": args.requests,
        "latency_ms_median": lat[len(lat) // 2],
        "latency_ms_p90": lat[int(0.9 * (len(lat) - 1))],
        "stages": stages,
        "profiled_wall_ms_per_request": wall_ms,
        "device_busy_ms_per_request": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_ops_per_request": launches / n_prof,
        "device_ms_by_group": groups,
        "top_kernels": [dict(name=k[:90], ms=ms, per_request=c)
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
