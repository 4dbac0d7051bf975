"""A cell at a size a CPU test run holds: the real cell's files with the
widths cut (PointNet++ tiers, a 2-layer RoBERTa, 32 queries, batch 2), for
the CPU tests of the harness. The program runs its plain PyTorch paths."""

import copy
import json
import os

from benchmark.harness import spec


def held_back_cell(name: str, chips: int) -> dict:
    """The workload file `name`, which BENCHMARK.json does not list yet,
    as the cell it would be there on `chips` GPUs: the listed cell of the
    same configuration and mix, with this file's entry, name and why."""
    with open(os.path.join(spec.BENCH_DIR, "workloads", name + ".json")) as f:
        entry = json.load(f)
    twin = next(w["name"] for w in spec.benchmark()["workloads"]
                if (w["config"], w["traffic"]) == (entry["config"],
                                                   entry["traffic"]))
    cell = spec.load_cell(twin)
    bench = dict(cell["bench"], name=name, chips=chips, why=entry["why"])
    return dict(cell, name=name, entry=entry, bench=bench)


def tiny_cell(name: str, batch: int = 2, cell: dict = None) -> dict:
    """The cell `name` (or `cell`, loaded) at the tiny widths."""
    cell = copy.deepcopy(cell or spec.load_cell(name))
    cfg = cell["config"]
    cfg["flags"].update(num_points=2048, num_target=32, max_num_obj=16,
                        max_det_boxes=16, batch_size=batch)
    cfg["model"].update(num_queries=32, backbone_npoints=[256, 128, 64, 32])
    cfg["text_encoder"].update(vocab_size=1024, hidden_size=64,
                               num_hidden_layers=2, num_attention_heads=4,
                               intermediate_size=128,
                               max_position_embeddings=130)
    cfg["data"].update(num_points=2048, max_num_obj=16, max_det_boxes=16)
    cell["traffic"].update(vocab_size=1024,
                           objects={"dist": "uniform", "min": 4, "max": 12})
    cell["entry"].update(batch=batch, pool_batches=4, warmup=1,
                         device_trace_steps=1, trace_steps=1)
    if cell["entry"]["entry"] == "eval":
        cell["entry"].update(judged_within=3, judged_batches=1)
    return cell
