#!/usr/bin/env python3
"""The attention backward (K4) at every shape a training step
differentiates, for the port.

    python3 scripts/profile_torch_attention_bwd.py [--batch 8] [--reps 20]
        [--seed 0] [--report PATH]

For each of the nine (Lq, Lk) of the training forward (B = `--batch`, 8
heads, Dh 36; the key padding of chip_smoke.py) it times, with CUDA events
over `--reps` back-to-back calls: K4 in the training mode (bf16 operands on
the tensor cores) at p = 0.1 and p = 0, K4 in the precise mode (f32 on
CUDA cores) at p = 0.1, autograd through scaled_dot_product_attention at
p = 0.1 and p = 0 (a yardstick the port never calls), and the dropout mask
writer of csrc/attention.cu, which draws the whole mask once with one
Philox call per group of 4 keys. K4's default mode draws the mask once
per walk over the keys (three walks: two in the dQ kernel, one in the dK/dV
kernel); drawing each group in both threads of a fragment pair instead
would draw it twice a walk, so `mask_ms` times 3 is what that alternative
would add. One profiled call per shape splits the device time between the
dQ and the dK/dV kernel. Prints one JSON object (also written to `--report
PATH`) with the card's name and power limit; times in ms. Needs one
NVIDIA GPU.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _device_us(fn):
    """Device µs of K4's two kernels in one call of `fn`, by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"dq": 0.0, "dkv": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for part in out:
            if f"attention_bwd_{part}_" in e.name:
                out[part] += e.time_range.elapsed_us()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", default=None,
                    help="also write the JSON result to this path")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("profile_torch_attention_bwd: no CUDA device", file=sys.stderr)
        return 2

    from chip_smoke import attention_shapes, time_ms
    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.lang import roberta_base_config
    from butd_detr_tpu_torch.ops import (
        _cuda,
        attention_backward,
        dropout_keep_mask,
    )

    _cuda.build_all()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    seed = 0x5EED0000 + args.seed
    B, reps = args.batch, args.reps
    shapes = [s for s in attention_shapes(butd_cls_config(),
                                          roberta_base_config(),
                                          (2048, 1024, 512, 256))
              if s[0] != "roberta_self"]  # frozen: never differentiated
    result = {"batch": B, "reps": reps, "shapes": []}
    totals = {}
    for name, H, Lq, Lk, Dh, pad_kind, per_step in shapes:
        q, k, v, do = (torch.randn(B, L, H, Dh, device="cuda",
                                   generator=gen).transpose(1, 2)
                       for L in (Lq, Lk, Lk, Lq))
        pad = torch.zeros(B, Lk, dtype=torch.bool, device="cuda")
        if pad_kind == "text":
            pad[:, 14:] = True
        elif pad_kind == "boxes":
            pad[:, 12:] = True
        else:
            pad[0, Lk - 5:] = True
        scale = Dh ** -0.5

        def k4(p, precise=False):
            return lambda: attention_backward(
                q, k, v, do, pad, sm_scale=scale, dropout_p=p, seed=seed,
                precise=precise)

        row = dict(name=name, H=H, Lq=Lq, Lk=Lk, Dh=Dh, per_step=per_step)
        row["ms"] = time_ms(k4(0.1), reps)
        row["ms_p0"] = time_ms(k4(0.0), reps)
        row["precise_ms"] = time_ms(k4(0.1, True), max(2, reps // 4))
        row["mask_ms"] = time_ms(lambda: dropout_keep_mask(
            seed, B, H, Lq, Lk, 0.1, device="cuda"), reps)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        for p, key in ((0.1, "sdpa_ms"), (0.0, "sdpa_ms_p0")):
            out = F.scaled_dot_product_attention(
                *leaves, attn_mask=~pad[:, None, None, :], scale=scale,
                dropout_p=p)
            row[key] = time_ms(lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), reps)
            del out
        del leaves
        split = _device_us(k4(0.1))
        row["device_us_dq"], row["device_us_dkv"] = split["dq"], split["dkv"]
        result["shapes"].append(row)
        for key in ("ms", "ms_p0", "precise_ms", "mask_ms", "sdpa_ms",
                    "sdpa_ms_p0"):
            totals[key] = totals.get(key, 0.0) + per_step * row[key]
        print(f"{name:20s} {Lq:4d}x{Lk:4d}: K4 {row['ms']:.3f} ms (p = 0 "
              f"{row['ms_p0']:.3f}, precise {row['precise_ms']:.3f}; device "
              f"dq {split['dq']:.0f} us, dkv {split['dkv']:.0f} us), SDPA "
              f"autograd {row['sdpa_ms']:.3f} (p = 0 {row['sdpa_ms_p0']:.3f})"
              f", mask {row['mask_ms']:.3f} x{per_step}", flush=True)
    result["per_step"] = totals
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
