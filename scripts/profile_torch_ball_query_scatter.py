#!/usr/bin/env python3
"""The ball query (K2) and the row scatter-add (K5) alone, and the device
time of an evaluation batch and of a training step, for the port.

    python3 scripts/profile_torch_ball_query_scatter.py [--batch 8]
        [--reps 10] [--seed 0] [--package-root DIR] [--report PATH]

K2: the four set-abstraction tiers (50000 -> 2048 -> 1024 -> 512 -> 256,
r 0.2/0.4/0.8/1.2, 64/32/16/16 samples) of one synthetic room
(chip_smoke.py's scene, B = 1: a request) and of the training batch's
clouds (`data.synthetic_batch`, B = `--batch`). K5: every row gather a
training step differentiates, on that batch's own ball-query and 3-NN
indices, in the step's dtype (chip_smoke.py:training_gathers), beside
`index_add_` (a yardstick the port never calls). For each: ms a call
(CUDA events over `--reps` back-to-back calls), the device time of a call
(all of its device work, the median of three profiled calls) and one
call's device time by kernel. Then the full-width SR3D butd_cls `Trainer`
with seeded random weights on those batches: the device busy time of one
evaluation forward (`eval_step`, no loss) and of one training step, with
K2's and K5's share, each the median of three profiled runs.

`--package-root DIR` imports `butd_detr_tpu_torch` from DIR instead of
this checkout, so that one copy of the script times two trees (the parent
and a change) on one card in turns; only the package's public entry
points are called. Prints one JSON object (also written to `--report
PATH`) with the card's name and power limit; times in ms. Needs one NVIDIA
GPU.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIERS = dict(radii=(0.2, 0.4, 0.8, 1.2), nsamples=(64, 32, 16, 16))


def _device_events(fn):
    """(name, us) of the device work of one call of `fn`, by
    torch.profiler; the ranges of `record_function`, which the profiler
    mirrors onto the device timeline, are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    host = {e.name for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA}
    return [(e.name, e.time_range.elapsed_us()) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in host]


def _device_ms(fn, *parts):
    """Device ms of the work whose name contains each of `parts` ("": all
    of it) in one call of `fn`: one number a part, or the total when no
    part is named."""
    events = _device_events(fn)
    sums = [sum(us for name, us in events if p in name) / 1e3
            for p in (parts or ("",))]
    return sums if parts else sums[0]


def _by_kernel(fn):
    """Device ms of one call of `fn` by kernel: the first word of its name
    that ends in `kernel`, else its name's first 24 characters."""
    import re

    out = {}
    for name, us in _device_events(fn):
        words = [w for w in re.findall(r"\w+", name) if w.endswith("kernel")]
        short = words[0] if words else name[:24]
        out[short] = out.get(short, 0.0) + us / 1e3
    return out


def _kernel_text(row):
    return "(" + ", ".join(f"{k} {v:.4f}" for k, v in row["kernels"].items()
                           ) + ")"


def _median(xs):
    return sorted(xs)[len(xs) // 2]


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

    if not torch.cuda.is_available():
        print("profile_torch_ball_query_scatter: no CUDA device",
              file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.abspath(args.package_root), ROOT]

    from chip_smoke import make_scene, sa_tiers, time_ms, training_gathers
    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.data import synthetic_batch
    from butd_detr_tpu_torch.lang import roberta_base_config
    from butd_detr_tpu_torch.ops import _cuda, ball_query, scatter_rows_add
    from butd_detr_tpu_torch.predict import prepare_point_cloud
    from butd_detr_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build_all()
    cfg, roberta = butd_cls_config(), roberta_base_config()
    npoints = (2048, 1024, 512, 256)
    B, reps = args.batch, args.reps
    batches = [synthetic_batch(
        batch_size=B, num_points=cfg.num_points,
        max_text_len=cfg.max_text_len, max_num_obj=cfg.max_num_obj,
        max_det_boxes=cfg.max_det_boxes, seed=args.seed + i,
        vocab_size=roberta.vocab_size, spatial_sort=cfg.spatial_sort)
        for i in range(5)]
    rng = np.random.RandomState(args.seed)
    scene = prepare_point_cloud(make_scene(rng)[0], cfg.num_points,
                                cfg.use_color)[None, :, :3]
    clouds = {1: torch.from_numpy(scene.copy()).cuda(),
              B: torch.from_numpy(
                  batches[0]["point_clouds"][..., :3].copy()).cuda()}
    result = {"batch": B, "reps": reps,
              "package": os.path.abspath(args.package_root),
              "ball_query": [], "scatter": []}
    totals = {}

    def add(key, val):
        totals[key] = totals.get(key, 0.0) + val

    tiers = {}
    for batch, cloud in clouds.items():
        tiers[batch] = sa_tiers(cloud, npoints, TIERS["radii"],
                                TIERS["nsamples"])
        for xyz, new_xyz, _, r, ns in tiers[batch]:
            call = lambda: ball_query(r, ns, xyz, new_xyz)  # noqa: E731
            ms = time_ms(call, reps)
            dev = _median([_device_ms(call) for _ in range(3)])
            row = dict(batch=batch, n=xyz.shape[1], m=new_xyz.shape[1],
                       radius=r, nsample=ns, ms=ms, device_ms=dev,
                       kernels=_by_kernel(call))
            result["ball_query"].append(row)
            add(f"ball_query_b{batch}_ms", ms)
            add(f"ball_query_b{batch}_device_ms", dev)
            print(f"ball query B={batch} {row['n']:6d} -> {row['m']:5d} "
                  f"r={r}: {ms:.4f} ms, device {dev:.4f} ms "
                  f"{_kernel_text(row)}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for name, dtype, per_step, idx, n, C in training_gathers(
            tiers[B], npoints, cfg, gen):
        g = torch.randn(idx.shape[0], idx.shape[1], C, device="cuda",
                        generator=gen).to(dtype)
        call = lambda: scatter_rows_add(g, idx, n)  # noqa: E731
        flat = (idx.long() + n * torch.arange(
            idx.shape[0], device="cuda")[:, None]).reshape(-1)
        gf = g.reshape(-1, C).float()
        ms = time_ms(call, reps)
        dev = _median([_device_ms(call) for _ in range(3)])
        lms = time_ms(lambda: torch.zeros(idx.shape[0] * n, C, device="cuda")
                      .index_add_(0, flat, gf), reps)
        row = dict(name=name, M=idx.shape[1], C=C, n=n, dtype=str(dtype),
                   per_step=per_step, ms=ms, device_ms=dev, library_ms=lms,
                   kernels=_by_kernel(call))
        result["scatter"].append(row)
        add("scatter_step_ms", per_step * ms)
        add("scatter_step_device_ms", per_step * dev)
        add("scatter_step_library_ms", per_step * lms)
        print(f"scatter {name:16s} M={row['M']:6d} C={C:3d} n={n:5d}: "
              f"{ms:.4f} ms, device {dev:.4f} ms (index_add_ {lms:.4f}) "
              f"x{per_step} {_kernel_text(row)}", flush=True)
    del tiers, clouds

    trainer = Trainer(cfg, steps_per_epoch=1000, roberta_config=roberta,
                      backbone_npoints=npoints, device="cuda",
                      seed=args.seed)
    trainer.train_step(batches[1])
    trainer.eval_step(batches[1], with_loss=False)
    paths = {}
    for what, fn in (
            ("evaluation", lambda b: trainer.eval_step(b, with_loss=False)),
            ("training", trainer.train_step)):
        runs = [dict(zip(("busy", "ball_query", "scatter"), _device_ms(
            lambda: fn(b), "", "ball_query_", "scatter_rows_add_")))
            for b in batches[2:5]]
        busy = _median([r["busy"] for r in runs])
        paths[what] = dict(busy_ms=busy, runs=runs,
                           ball_query_ms=_median(
                               [r["ball_query"] for r in runs]),
                           scatter_ms=_median([r["scatter"] for r in runs]))
        print(f"{what} batch of {B}: device busy {busy:.3f} ms (ball query "
              f"{paths[what]['ball_query_ms']:.3f}, scatter "
              f"{paths[what]['scatter_ms']:.3f})", flush=True)
    result["paths"] = paths
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
