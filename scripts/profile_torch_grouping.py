#!/usr/bin/env python3
"""The four set-abstraction groupings of the bf16 backbone alone, and the
device time of the paths around them, for the port.

    python3 scripts/profile_torch_grouping.py [--batch 8] [--reps 20]
        [--seed 0] [--paths] [--package-root DIR] [--report PATH]

Groupings: the tiers 50000 -> 2048 x 64 (3 colour channels), 2048 -> 1024
x 32 (128), 1024 -> 512 x 16 (256), 512 -> 256 x 16 (256) of one synthetic
room (chip_smoke.py's scene, B = 1: a request) and of the training batch's
clouds (`data.synthetic_batch`, B = `--batch`), on their own ball-query
indices, sa1's xyz a strided view of the cloud as the backbone hands it
over. Two forms of the MLP's bf16 input:
  chain  what the bf16 `QueryAndGroup` ran before the fused op:
         `group_points_split` (the grouped copy kernel), the centre
         subtraction, the radius scale, `torch.cat` (which promotes the
         features to f32) and the MLP's cast to bf16;
  fused  `group_points_mlp_input`, one kernel (when the package has it).
For each: ms a forward (CUDA events over `--reps` back-to-back calls), the
device time of one forward and of one forward + backward (the features'
gradient, a bf16 cotangent) by kernel, and their device operations.

`--paths` adds the full-width SR3D butd_cls model with seeded random
weights: the device busy time of one evaluation forward (`eval_step`, no
loss) and of one training step (`train_step`), each the median of three
profiled runs, the device operations of one request
(`GroundingPredictor.predict`), and the peak device memory of each.

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
TIERS = dict(radii=(0.2, 0.4, 0.8, 1.2), nsamples=(64, 32, 16, 16))
FEATURES = (3, 128, 256, 256)  # channels entering each tier


def _forms(ops, torch):
    """{form: fn(xyz, new_xyz, feats, idx, inv_r) -> bf16 MLP input}."""
    def chain(xyz, new_xyz, feats, idx, inv_r):
        gx, gf = ops.group_points_split(xyz, feats, idx)
        grouped_xyz = (gx - new_xyz[:, :, None, :]) * inv_r
        return torch.cat([grouped_xyz, gf], dim=-1).to(torch.bfloat16)

    forms = {"chain": chain}
    if hasattr(ops, "group_points_mlp_input"):
        forms["fused"] = ops.group_points_mlp_input
    return forms


def _groupings(args, tiers_by_batch, gen):
    import numpy as np
    import torch

    from profile_torch_ball_query_scatter import (
        _by_kernel,
        _device_events,
        _kernel_text,
    )
    from chip_smoke import time_ms
    import butd_detr_tpu_torch.ops as ops

    forms = _forms(ops, torch)
    rows, totals = [], {}
    for batch, tiers in tiers_by_batch.items():
        for t, (xyz, new_xyz, _, r, ns) in enumerate(tiers):
            n, m, c = xyz.shape[1], new_xyz.shape[1], FEATURES[t]
            idx = ops.ball_query(r, ns, xyz, new_xyz)
            if t == 0:  # sa1: xyz and colour of one (B, N, 6) cloud
                cloud = torch.cat([xyz, torch.rand(batch, n, 3, device="cuda",
                                                   generator=gen)], -1)
                src, feats = cloud[..., :3], cloud[..., 3:].to(torch.bfloat16)
            else:
                src = xyz
                feats = torch.randn(batch, n, c, device="cuda",
                                    generator=gen).to(torch.bfloat16)
            inv_r = float(np.float32(1) / np.float32(r))
            ct = torch.randn(batch, m, ns, 3 + c, device="cuda",
                             generator=gen).to(torch.bfloat16)
            for form, fn in forms.items():
                call = lambda: fn(src, new_xyz, feats, idx, inv_r)  # noqa
                leaf = feats.clone().requires_grad_()

                def both():
                    fn(src, new_xyz, leaf, idx, inv_r).backward(ct)

                with torch.no_grad():
                    ms = time_ms(call, args.reps)
                    fwd = _by_kernel(call)
                    n_fwd = len(_device_events(call))
                bwd = _by_kernel(both)
                n_both = len(_device_events(both))
                row = dict(batch=batch, tier=f"sa{t + 1}", n=n, m=m, ns=ns,
                           C=c, form=form, ms=ms,
                           device_ms=sum(fwd.values()),
                           device_ms_fwd_bwd=sum(bwd.values()),
                           ops=n_fwd, ops_fwd_bwd=n_both, kernels=fwd,
                           kernels_fwd_bwd=bwd)
                rows.append(row)
                for key in ("ms", "device_ms", "device_ms_fwd_bwd", "ops",
                            "ops_fwd_bwd"):
                    k = f"{form}_b{batch}_{key}"
                    totals[k] = totals.get(k, 0.0) + row[key]
                print(f"B={batch} sa{t + 1} {form:5s}: {ms:.4f} ms, device "
                      f"{row['device_ms']:.4f} ms in {n_fwd} ops "
                      f"{_kernel_text(dict(kernels=fwd))}; with backward "
                      f"{row['device_ms_fwd_bwd']:.4f} ms in {n_both} ops",
                      flush=True)
    return rows, totals


def _paths(args, batches, gen):
    """Device busy ms, device operations and peak memory of a request, an
    evaluation forward and a training step at full width."""
    import numpy as np
    import torch

    from profile_torch_ball_query_scatter import _device_events, _median
    from chip_smoke import REQUESTS, make_scene
    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.lang import roberta_base_config
    from butd_detr_tpu_torch.predict import GroundingPredictor
    from butd_detr_tpu_torch.train import Trainer

    cfg, roberta = butd_cls_config(), roberta_base_config()
    npoints = (2048, 1024, 512, 256)
    out = {}

    def measure(what, fn, inputs):
        fn(inputs[0])  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for x in inputs[1:]:
            ev = _device_events(lambda: fn(x))
            runs.append(dict(busy=sum(us for _, us in ev) / 1e3,
                             ops=len(ev)))
        out[what] = dict(busy_ms=_median([r["busy"] for r in runs]),
                         ops=_median([r["ops"] for r in runs]), runs=runs,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        print(f"{what}: device busy {out[what]['busy_ms']:.3f} ms in "
              f"{out[what]['ops']} device operations, peak "
              f"{out[what]['peak_gib']:.3f} GiB", flush=True)

    rng = np.random.RandomState(args.seed)
    scene = make_scene(rng)
    pred = GroundingPredictor(cfg, roberta_config=roberta,
                              backbone_npoints=npoints, device="cuda",
                              seed=args.seed)
    utt, phrase = REQUESTS[0]
    measure("request", lambda s: pred.predict(
        s[0], utt, phrase=phrase, det_boxes=s[1], det_class_ids=s[2],
        mode="bbf", top_k=10), [scene] * 4)
    del pred
    torch.cuda.empty_cache()
    trainer = Trainer(cfg, steps_per_epoch=1000, roberta_config=roberta,
                      backbone_npoints=npoints, device="cuda",
                      seed=args.seed)
    measure("evaluation", lambda b: trainer.eval_step(b, with_loss=False),
            batches[1:5])
    measure("training", trainer.train_step, batches[1:5])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paths", action="store_true",
                    help="also profile a request, an evaluation forward and "
                    "a training step at full width")
    ap.add_argument("--package-root", default=ROOT,
                    help="directory holding the butd_detr_tpu_torch to time")
    ap.add_argument("--report", default=None,
                    help="also write the JSON result to this path")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_grouping: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.abspath(args.package_root), ROOT,
                    os.path.join(ROOT, "scripts")]

    from chip_smoke import make_scene, sa_tiers
    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.data import synthetic_batch
    from butd_detr_tpu_torch.lang import roberta_base_config
    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.predict import prepare_point_cloud

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.build_all()
    cfg, roberta = butd_cls_config(), roberta_base_config()
    npoints = (2048, 1024, 512, 256)
    B = args.batch
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
    tiers = {b: sa_tiers(c, npoints, TIERS["radii"], TIERS["nsamples"])
             for b, c in clouds.items()}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"batch": B, "reps": args.reps,
              "package": os.path.abspath(args.package_root)}
    result["groupings"], result["totals"] = _groupings(args, tiers, gen)
    del tiers, clouds
    torch.cuda.empty_cache()
    if args.paths:
        result["paths"] = _paths(args, batches, gen)
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
