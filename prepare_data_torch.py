#!/usr/bin/env python
"""Pre-parse all ScanNet scans of a data root into per-split scan caches.

The port's counterpart of `prepare_data.py` (reference prepare_data.py ->
save_data, joint_det_dataset.py:1000-1029): loads every scan of each split
with a pool of spawned workers and pickles {scan_id: Scan} to
`{data_root}/{split}_v3scans.pkl`, the file `train_torch.py` reads (and
`train.py` too: the JAX package reads the port's cache, and the port the
JAX package's). Imports only the port's data package.

    python prepare_data_torch.py --data_root ./data [--splits train val]
                                 [--num_workers 4]
"""

import argparse
import os.path as osp
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data_root", default="./")
    parser.add_argument("--splits", nargs="+", default=["train", "val"])
    parser.add_argument("--num_workers", type=int, default=4)
    args = parser.parse_args(argv)

    from butd_detr_tpu_torch.data.scan import save_scan_cache

    for split in args.splits:
        out = osp.join(args.data_root, f"{split}_v3scans.pkl")
        t0 = time.time()
        save_scan_cache(out, split, args.data_root, args.num_workers)
        print(f"{split}: wrote {out} in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
