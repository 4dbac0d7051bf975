#!/usr/bin/env python3
"""A serving request's host time, for the port: where the wall clock goes
when the host, not the card, sets the latency.

    python3 scripts/profile_torch_serving_host.py [--requests 40]
        [--package-root DIR]

Builds the full-width SR3D butd_cls GroundingPredictor on `cuda` with
seeded random weights (as chip_smoke.py does), warms it up, then prints
one line: the median (p10, p90) latency of `--requests` requests on the
host clock; over 20 more forwards the median input preparation, dispatch
(until the forward returns, before any sync) and sync wait (what the host
then waits for the card); and the host's enqueue cost of one FPS call at
50000 points and of one small attention call (128 x 128, 8 heads, Dh 36,
no gradient), each over back-to-back calls. Run from the root of a
checkout; `--package-root DIR` imports `butd_detr_tpu_torch` from DIR
instead, so that one call times the parent and a change in turns. Needs
one NVIDIA GPU.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _median(x):
    return sorted(x)[len(x) // 2]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--package-root", default=ROOT,
                    help="directory holding the butd_detr_tpu_torch to time")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_serving_host: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.abspath(args.package_root), ROOT]

    from chip_smoke import REQUESTS, make_scene
    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.ops import attention, furthest_point_sample
    from butd_detr_tpu_torch.predict import GroundingPredictor

    torch.backends.cuda.matmul.allow_tf32 = False
    pred = GroundingPredictor(butd_cls_config(), device="cuda", seed=0)
    rng = np.random.RandomState(0)
    scenes = [make_scene(rng) for _ in range(4)]

    def request(i):
        cloud, boxes, cids = scenes[i % len(scenes)]
        utt, phrase = REQUESTS[i % len(REQUESTS)]
        return pred.predict(cloud, utt, phrase=phrase, det_boxes=boxes,
                            det_class_ids=cids, top_k=10)

    for i in range(5):
        request(i)
    lat = []
    for i in range(args.requests):
        t = time.perf_counter()
        request(i)
        lat.append((time.perf_counter() - t) * 1e3)
    disp, wait, prep = [], [], []
    cloud, boxes, cids = scenes[0]
    for i in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inputs = pred.make_inputs(cloud, REQUESTS[0][0], boxes, cids)
        t1 = time.perf_counter()
        with torch.inference_mode():
            pred.model(inputs)
            t2 = time.perf_counter()
            torch.cuda.synchronize()
        t3 = time.perf_counter()
        prep.append((t1 - t0) * 1e3)
        disp.append((t2 - t1) * 1e3)
        wait.append((t3 - t2) * 1e3)
    xyz = torch.rand(1, 50000, 3, device="cuda") * 4
    furthest_point_sample(xyz, 2048)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        furthest_point_sample(xyz, 2048)
    fps_us = (time.perf_counter() - t) / 20 * 1e6
    torch.cuda.synchronize()
    q = torch.randn(1, 128, 8, 36, device="cuda").transpose(1, 2)
    pad = torch.zeros(1, 128, dtype=torch.bool, device="cuda")
    with torch.inference_mode():
        for _ in range(50):
            attention(q, q, q, pad, sm_scale=0.16)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(500):
            attention(q, q, q, pad, sm_scale=0.16)
        att_us = (time.perf_counter() - t) / 500 * 1e6
        torch.cuda.synchronize()
    lat.sort()
    print(f"{args.package_root}: latency median {_median(lat):.2f} ms (p10 "
          f"{lat[len(lat) // 10]:.2f}, p90 {lat[len(lat) * 9 // 10]:.2f}); "
          f"prep {_median(prep):.2f}, dispatch {_median(disp):.2f}, sync "
          f"wait {_median(wait):.2f} ms; fps enqueue {fps_us:.1f} us; "
          f"attention enqueue {att_us:.1f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
