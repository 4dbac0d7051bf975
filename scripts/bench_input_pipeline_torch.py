#!/usr/bin/env python3
"""The host's input pipeline alone, for the PyTorch port: the scenes a
second that augmentation (50,000-point clouds), tokenization, positive
maps, collation to fixed shapes and the loader's workers can feed, with
no device in the loop.

Counterpart of scripts/bench_input_pipeline.py, on the same data:
`make_rich_scannet` scenes (written under `--out`, in a folder of their
point and scene counts, when missing), the
butd grounding dataset with colour and `SimpleTokenizer`, the port's
`DataLoader` with `--workers` spawned workers. 3 warm batches, then
`--batches` timed ones, wrapping over epochs as a training run would.

    python3 scripts/bench_input_pipeline_torch.py [--workers N]
        [--batch 24] [--points 50000] [--scenes 12] [--batches 20]
        [--out DIR]  (default: $TMPDIR/bench_input_pipeline_torch)

Prints one JSON line: the JAX script's keys (`scenes_per_sec`,
`ms_per_batch`, ...) and `warmup_s`, the seconds from the first request
for a batch to the third batch (the workers' start and first prefetch).
"""

import argparse
import json
import os
import os.path as osp
import sys
import tempfile
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from butd_detr_tpu_torch.data import (  # noqa: E402
    DataLoader,
    JointGroundingDataset,
    load_scans_parallel,
    make_rich_scannet,
)
from butd_detr_tpu_torch.lang.tokenizer import SimpleTokenizer  # noqa: E402

WARM_BATCHES = 3


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=os.cpu_count())
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--points", type=int, default=50000)
    ap.add_argument("--scenes", type=int, default=12)
    ap.add_argument("--batches", type=int, default=20,
                    help="timed batches (after a 3-batch warmup)")
    ap.add_argument("--out", default=osp.join(tempfile.gettempdir(),
                                              "bench_input_pipeline_torch"))
    args = ap.parse_args(argv)
    if min(args.batch, args.batches, args.scenes) < 1:
        ap.error("--batch, --batches and --scenes must be >= 1")
    return args


def data_root(args: argparse.Namespace) -> str:
    """The scenes' root under `args.out`, one for each point and scene
    count, so that a run never reads another run's scenes."""
    return osp.join(args.out, f"data_p{args.points}_s{args.scenes}")


def build_loader(args: argparse.Namespace) -> DataLoader:
    """The loader of bench_input_pipeline.py:44-66 on `data_root(args)`
    (written first when missing)."""
    root = data_root(args)
    if not osp.exists(osp.join(root, "refer_it_3d", "sr3d.csv")):
        make_rich_scannet(root, n_train=args.scenes, n_val=2,
                          objects_per_scan=5, points_per_scan=args.points)
    with open(osp.join(root, "meta_data", "scannetv2_train.txt")) as f:
        ids = [line.strip() for line in f if line.strip()]
    scans = load_scans_parallel(
        ids, osp.join(root, "scans"), osp.join(root, "meta_data"),
        num_workers=args.workers or 1, keep_points=args.points)
    dataset = JointGroundingDataset(
        dataset_dict={"sr3d": 1}, split="train", test_dataset="sr3d",
        data_path=root, scans=scans, tokenizer=SimpleTokenizer(max_len=32),
        use_color=True, butd=True, max_text_len=32, max_num_obj=16,
        max_det_boxes=16)
    return DataLoader(dataset, batch_size=args.batch, shuffle=True, seed=0,
                      num_workers=args.workers)


def main(argv=None) -> int:
    args = parse_args(argv)
    loader = build_loader(args)
    if len(loader) == 0:
        raise SystemExit(f"the {len(loader.dataset)} samples make no batch "
                         f"of {args.batch}")
    need = args.batches + WARM_BATCHES
    done = epoch = 0
    start = time.perf_counter()
    try:
        while done < need:
            loader.set_epoch(epoch)
            for _ in loader:
                done += 1
                if done == WARM_BATCHES:
                    t0 = time.perf_counter()
                if done >= need:
                    break
            epoch += 1
    finally:
        loader.close()
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": "host_input_pipeline_scenes_per_sec",
        "scenes_per_sec": round(args.batch * args.batches / dt, 2),
        "ms_per_batch": round(1000 * dt / args.batches, 1),
        "workers": args.workers,
        "batch": args.batch,
        "points": args.points,
        "host_cpus": os.cpu_count(),
        "warmup_s": round(t0 - start, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
