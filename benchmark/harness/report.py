"""The result of one run: its metrics read by the readers that
`BENCHMARK.json` names, the device, the breakdown of a traced run, and the
numbers compared beside their limits; the earlier lines on standard error
(the card's power limit, kernel launches a step, each kernel function's
share of its roofline)."""

import json
import math
import subprocess
import sys
from typing import Dict, List

import torch

from benchmark.harness import readers, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "butd_detr_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that a run must not load, compared
    whole: `butd_detr_tpu_torch` is not `butd_detr_tpu`."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card(device) -> Dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1}


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi not read: {e}"
    return out


def result(cell: Dict, res: Dict, traced: bool, device) -> Dict:
    run = res["run"]
    metrics = {}
    wanted = cell["per_layer"] if traced else cell["end_to_end"]
    for m in wanted:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = dict(res["device"] if "device" in res else card(device),
               memory_peak_bytes=res["peak"])
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": 0, "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
    line["checks"] = res["checks"]
    return line


def earlier_lines(res: Dict, device) -> None:
    run = res["run"]
    if torch.device(device).type == "cuda":
        log("card:", power_line())
    log("set-up s:", json.dumps(run.setup_parts))
    log("launches a step:", json.dumps(res["launches_per_step"],
                                       sort_keys=True))
    log(f"window: {run.window_s:.4f} s, {res['attempted']} "
        f"{'steps' if run.mode == 'train' else 'batches'}, {run.scenes} "
        f"scenes; {run.flops_per_scene:.6g} FLOP a scene")
    if run.trace is not None:
        log(f"trace: {run.trace_steps} traced steps, "
            f"{run.trace['device_events']} device operations, busy "
            f"{run.trace['busy_s']:.6f} s of {run.trace['window_s']:.6f} s")
        nccl = readers.collective_ms(run, run.mode)
        if nccl is not None:
            log(f"collectives: {nccl:.4f} device-ms a step in NCCL kernels "
                f"(rank 0), idle {readers.idle_share(run, run.mode):.4f} %")
    for fn, (share, t) in readers.function_shares(run).items():
        log(f"roofline {fn}: {share:.4f} % ({t * 1e3:.4f} device-ms in "
            f"{run.trace_steps} traced steps)")
    log("numbers:", json.dumps(res["numbers"], sort_keys=True))


def check_lines(checks: Dict) -> None:
    for name, c in checks.items():
        ok = math.isfinite(c["value"]) and c["value"] <= c["limit"]
        log(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if ok else 'FAILED'}")
