#!/usr/bin/env python3
"""Furthest-point sampling (K1) and the attention forward (K3) alone, at
every shape a request, an evaluation batch and a training step launch
them, for the port.

    python3 scripts/profile_torch_fps_attention.py [--batch 8] [--reps 10]
        [--seed 0] [--package-root DIR] [--report PATH]

K1: the four set-abstraction tiers (50000 -> 2048 -> 1024 -> 512 -> 256)
of a synthetic room (chip_smoke.py's scenes), at B = 1 and at B = `--batch`
(the training batch's clouds): ms a call (CUDA events over `--reps`
back-to-back calls), us a step (ms / (npoint - 1)) and the kernel's device
time in one profiled call. K3: every (H, Lq, Lk, Dh) of the forward with
its key padding, at B = 1 and p = 0 (serving) and at B = `--batch` with
p = 0 (evaluation) and p = 0.1 (training), each beside
scaled_dot_product_attention at the same B and p (a yardstick the port
never calls), and K3's device time. Sums: a request's 4 FPS and 51
attention calls, an evaluation batch's, a training step's forward (the
frozen text tower runs without dropout).

`--package-root DIR` imports `butd_detr_tpu_torch` from DIR instead of
this checkout, so that one copy of the script times two trees (the parent
and a change) on one card in turns; only the package's public ops are
called. Prints one JSON object (also written to `--report PATH`) with the
card's name and power limit; times in ms unless named us. Needs one NVIDIA
GPU.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_us(fn, part):
    """Device us of the kernels whose name contains `part` in one call of
    `fn`, by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and part in e.name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--package-root", default=ROOT,
                    help="directory holding the butd_detr_tpu_torch to time")
    ap.add_argument("--report", default=None,
                    help="also write the JSON result to this path")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("profile_torch_fps_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.abspath(args.package_root), ROOT]

    from chip_smoke import attention_shapes, make_scene, sa_tiers, time_ms
    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.lang import roberta_base_config
    from butd_detr_tpu_torch.ops import (
        _cuda,
        attention,
        furthest_point_sample,
    )
    from butd_detr_tpu_torch.predict import prepare_point_cloud

    _cuda.build_all()
    cfg, roberta = butd_cls_config(), roberta_base_config()
    npoints = (2048, 1024, 512, 256)
    B, reps = args.batch, args.reps
    rng = np.random.RandomState(args.seed)
    clouds = [prepare_point_cloud(make_scene(rng)[0], cfg.num_points,
                                  cfg.use_color)[:, :3] for _ in range(B)]
    xyz = torch.from_numpy(np.stack(clouds)).cuda()
    result = {"batch": B, "reps": reps,
              "package": os.path.abspath(args.package_root),
              "fps": [], "attention": []}
    totals = {}

    def add(key, val):
        totals[key] = totals.get(key, 0.0) + val

    for batch, cloud in ((1, xyz[:1]), (B, xyz)):
        for pts, _, npoint, _, _ in sa_tiers(cloud, npoints,
                                             (0.2, 0.4, 0.8, 1.2),
                                             (64, 32, 16, 16)):
            call = lambda: furthest_point_sample(pts, npoint)  # noqa: E731
            ms = time_ms(call, reps)
            dev = _device_us(call, "fps") / 1e3
            row = dict(batch=batch, n=pts.shape[1], npoint=npoint, ms=ms,
                       us_per_step=ms * 1e3 / (npoint - 1), device_ms=dev)
            result["fps"].append(row)
            add(f"fps_b{batch}_ms", ms)
            add(f"fps_b{batch}_device_ms", dev)
            print(f"fps B={batch} {row['n']:6d} -> {npoint:5d}: {ms:.3f} ms, "
                  f"{row['us_per_step']:.3f} us a step, device {dev:.3f} ms",
                  flush=True)
    del xyz

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    seed = 0x5EED0000 + args.seed
    for name, H, Lq, Lk, Dh, pad_kind, per_pass in attention_shapes(
            cfg, roberta, npoints):
        scale = Dh ** -0.5
        p_train = 0.0 if name == "roberta_self" else 0.1
        row = dict(name=name, H=H, Lq=Lq, Lk=Lk, Dh=Dh, per_pass=per_pass)
        for batch, ps in ((1, (0.0,)), (B, (0.0, 0.1))):
            q, k, v = (torch.randn(batch, L, H, Dh, device="cuda",
                                   generator=gen).transpose(1, 2)
                       for L in (Lq, Lk, Lk))
            pad = torch.zeros(batch, Lk, dtype=torch.bool, device="cuda")
            if pad_kind == "text":
                pad[:, 14:] = True
            elif pad_kind == "boxes":
                pad[:, 12:] = True
            amask = ~pad[:, None, None, :]
            for p in ps:
                k3 = lambda: attention(  # noqa: E731
                    q, k, v, pad, sm_scale=scale, dropout_p=p, seed=seed)
                tag = f"b{batch}_p{p:g}"
                row[f"{tag}_ms"] = time_ms(k3, reps)
                row[f"{tag}_device_ms"] = _device_us(k3, "attention") / 1e3
                row[f"{tag}_sdpa_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=amask, scale=scale, dropout_p=p),
                    reps)
            del q, k, v, pad, amask
        result["attention"].append(row)
        for what, tag in (("request", "b1_p0"), ("evaluation", f"b{B}_p0"),
                          ("training", f"b{B}_p{p_train:g}")):
            for suffix in ("ms", "device_ms", "sdpa_ms"):
                add(f"attention_{what}_{suffix}",
                    per_pass * row[f"{tag}_{suffix}"])
        print(f"attention {name:20s} {Lq:4d}x{Lk:4d}: B=1 "
              f"{row['b1_p0_ms']:.3f} ms (sdpa {row['b1_p0_sdpa_ms']:.3f}, "
              f"device {row['b1_p0_device_ms']:.3f}); B={B} p = 0 "
              f"{row[f'b{B}_p0_ms']:.3f} (sdpa "
              f"{row[f'b{B}_p0_sdpa_ms']:.3f}), p = 0.1 "
              f"{row[f'b{B}_p0.1_ms']:.3f} (sdpa "
              f"{row[f'b{B}_p0.1_sdpa_ms']:.3f}) x{per_pass}", flush=True)
    result["totals"] = totals
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
