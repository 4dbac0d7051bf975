#!/usr/bin/env python3
"""The train step's time by model stage, for the PyTorch port.

Counterpart of scripts/bench_backward.py, at its workload: the butd
setup with contrastive alignment and the soft-token loss, B = 24 scenes of
50,000 points, L 64, 132 GT and 132 detected boxes, RoBERTa-base, the
backbone's MLPs in bf16, seeded random weights and a `synthetic_batch`.
The stages are the model's own submodules, each run in train mode:
  backbone  `backbone_net` (sum of the fp2 features)
  text      `text_encoder`, forward only (frozen in the step)
  encoder   `cross_encoder` on seeded activations
  decoder   the decoder layers in sequence on seeded activations
  heads7    the proposal head and every prediction head
  loss      the Hungarian loss on a train-mode forward's end points,
            differentiated with respect to the predicted centres, sizes,
            class scores, contrastive projections and kps logits
`<stage>_fwd` runs under `torch.no_grad()`; `<stage>_fwdbwd` is the same
scalar's forward plus `backward()`; `<stage>_bwd` is their difference.
Beside them: FPS at sa1 (`canary_fps_tier1`), `Trainer.train_step`
(`full_step`), the whole loss's value and value + gradient over every
parameter (`fwd_loss_value`, `fwd_loss_grad`, their difference
`bwd_total`) and the clip + AdamW update on those gradients
(`adamw_update`, `Trainer.apply_gradients`).

Each entry is the median of BENCH_REPS host-clock calls after 2 warm
calls, each call ending in `torch.cuda.synchronize()`. On the GPU one
`torch.profiler` pass of each timed call gives `<entry>_device_ms`:
every device event in it (kernels, copies, sets), summed (None on the
CPU: not measured). A failure raises: the script then exits non-zero.

    python3 scripts/bench_backward_torch.py [--device cuda]
    BENCH_TINY=1 python3 scripts/bench_backward_torch.py --device cpu

Env: BENCH_TINY (1: bench_backward.py's tiny config), BENCH_BATCH
(default 24; 8 when tiny), BENCH_REPS (default 10). Prints one JSON object:
the entries in ms, `peak_gib` (the device's peak allocation) and
`device` (the card's name and power limit from nvidia-smi).
"""

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from butd_detr_tpu_torch.config import Config  # noqa: E402
from butd_detr_tpu_torch.data import synthetic_batch  # noqa: E402
from butd_detr_tpu_torch.lang import (  # noqa: E402
    roberta_base_config,
    tiny_roberta_config,
)
from butd_detr_tpu_torch.losses import compute_hungarian_loss  # noqa: E402
from butd_detr_tpu_torch.nn.attention import MultiheadAttention  # noqa: E402
from butd_detr_tpu_torch.nn.dropout import Dropout  # noqa: E402
from butd_detr_tpu_torch.ops import furthest_point_sample  # noqa: E402
from butd_detr_tpu_torch.predict import resolve_device  # noqa: E402
from butd_detr_tpu_torch.train import (  # noqa: E402
    INPUT_KEYS,
    TARGET_KEYS,
    Trainer,
    criterion_config,
)

STAGES = ("backbone", "encoder", "decoder", "heads7", "loss")
# the seed of the encoder's, decoder's and heads' stand-in inputs
ACTIVATION_SEED = 1
# untimed calls before each entry's timed ones
WARM_CALLS = 2
# end points the loss stage differentiates (bench_backward.py:288-292)
LOSS_INPUT_SUFFIXES = ("center", "pred_size", "sem_cls_scores",
                       "proj_queries", "proj_tokens")


class Stage(NamedTuple):
    """`outputs()` runs the stage and gives its output tensors by name;
    `run()` is their sum, the scalar the timer differentiates. `params`
    (by the model's parameter names) and `inputs` (by name) are the
    tensors whose gradients its backward computes (both empty for the
    frozen text tower)."""
    outputs: Callable[[], Dict[str, torch.Tensor]]
    params: Dict[str, torch.nn.Parameter]
    inputs: Dict[str, torch.Tensor]

    def run(self) -> torch.Tensor:
        return sum(o.float().sum() for o in self.outputs().values())

    @property
    def wrt(self) -> List[torch.Tensor]:
        return [*self.params.values(), *self.inputs.values()]


def bench_setup(tiny: bool, batch_size: int):
    """(cfg, RoBERTa config, backbone npoints, batch) of
    bench_backward.py:94-111."""
    n_points = 512 if tiny else 50000
    mno = 8 if tiny else 132
    text_len = 12 if tiny else 64
    cfg = Config(
        use_contrastive_align=True, use_soft_token_loss=True, butd=True,
        self_attend=True, use_color=True, batch_size=batch_size,
        max_num_obj=mno, max_det_boxes=mno, max_text_len=text_len,
        **(dict(num_encoder_layers=1, num_decoder_layers=1,
                num_target=16, num_points=n_points) if tiny else {}))
    npoints = (64, 32, 16, 8) if tiny else (2048, 1024, 512, 256)
    roberta = tiny_roberta_config() if tiny else roberta_base_config()
    batch = synthetic_batch(batch_size=batch_size, num_points=n_points,
                            num_feats=3, max_text_len=text_len,
                            max_num_obj=mno, max_det_boxes=mno)
    return cfg, roberta, npoints, batch


def set_dropout(model: torch.nn.Module, p: float) -> None:
    """Every elementwise dropout and attention-probability dropout of
    `model` at rate `p`."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = p
        elif isinstance(m, MultiheadAttention):
            m.dropout = p


def stage_activations(batch_size: int, n_seeds: int, text_len: int,
                      n_det: int, n_queries: int, d: int = 288
                      ) -> Dict[str, np.ndarray]:
    """Standard-normal f32 stand-ins for the encoder's and decoder's
    inputs, at bench_backward.py:201-209 and :227-230's shapes, and the
    heads' base xyz (:257)."""
    rng = np.random.RandomState(ACTIVATION_SEED)
    shapes = dict(vis=(n_seeds, d), pos=(n_seeds, d), txt=(text_len, d),
                  det=(n_det, d), query=(n_queries, d),
                  query_pos=(n_queries, 6), base_xyz=(n_queries, 3))
    return {k: rng.standard_normal((batch_size, *s)).astype(np.float32)
            for k, s in shapes.items()}


def build_stages(model, cfg: Config, batch: Dict[str, np.ndarray],
                 npoints, device, dropout: Optional[float] = None
                 ) -> Dict[str, Stage]:
    """The stages of `model` (in train mode) on `batch` and on seeded
    activations (`stage_activations`). `dropout`: None keeps the model's
    rates, a number replaces every rate (`set_dropout`)."""
    if dropout is not None:
        set_dropout(model, dropout)
    model.train()
    dtype = model.dtype
    B, L = batch["text_ids"].shape
    act = stage_activations(B, npoints[1], L, cfg.max_det_boxes,
                            cfg.num_target)

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    vis, txt, query = (on_device(act[k]).to(dtype).requires_grad_()
                       for k in ("vis", "txt", "query"))
    pos, det, query_pos = (on_device(act[k]).to(dtype)
                           for k in ("pos", "det", "query_pos"))
    base_xyz = on_device(act["base_xyz"])
    vis_mask = torch.zeros((B, npoints[1]), dtype=torch.bool, device=device)
    text_pad = on_device(batch["text_mask"]) == 0
    det_pad = ~on_device(batch["det_bbox_label_mask"])

    def trainable(*prefixes):
        return {n: p for n, p in model.named_parameters()
                if p.requires_grad and n.startswith(prefixes)}

    cloud = on_device(batch["point_clouds"])

    def backbone():
        return {"fp2_features": model.backbone_net(cloud)["fp2_features"]}

    ids, mask = on_device(batch["text_ids"]), on_device(batch["text_mask"])

    def text():
        return {"text": model.text_encoder(ids, mask)}

    def encoder():
        v, t = model.cross_encoder(vis, pos, vis_mask, txt, text_pad, det,
                                   det_pad)
        return {"vis": v, "txt": t}

    def decoder():
        q = query
        for layer in model.decoder:
            q = layer(q, vis, txt, query_pos, None, text_pad, det, det_pad)
        return {"query": q}

    heads = [model.proposal_head, *model.prediction_heads]

    def heads7():
        return {f"{i}.{k}": v for i, h in enumerate(heads)
                for k, v in h(query, base_xyz).items()}

    with torch.no_grad():
        end_points = model({k: on_device(batch[k]) for k in INPUT_KEYS})
    for k in TARGET_KEYS:
        end_points[k] = on_device(batch[k])
    diff = {k: v.detach().requires_grad_() for k, v in end_points.items()
            if k.endswith(LOSS_INPUT_SUFFIXES)
            or k == "seeds_obj_cls_logits"}
    rest = {k: v for k, v in end_points.items() if k not in diff}
    criterion = criterion_config(cfg)

    def loss():
        return {"loss": compute_hungarian_loss(
            dict(rest, **diff), cfg.num_decoder_layers, criterion,
            cfg.query_points_obj_topk)[0]}

    return {
        "backbone": Stage(backbone, trainable("backbone_net."), {}),
        "text": Stage(text, {}, {}),
        "encoder": Stage(encoder, trainable("cross_encoder."),
                         dict(vis=vis, txt=txt)),
        "decoder": Stage(decoder, trainable("decoder."),
                         dict(query=query, vis=vis, txt=txt)),
        "heads7": Stage(heads7, trainable("proposal_head.",
                                          "prediction_heads."),
                        dict(query=query)),
        "loss": Stage(loss, {}, diff),
    }


def forward_only(run: Callable[[], torch.Tensor]) -> Callable[[], None]:
    def fwd():
        with torch.no_grad():
            run()
    return fwd


def forward_backward(stage: Stage) -> Callable[[], None]:
    def fwdbwd():
        for t in stage.wrt:
            t.grad = None
        stage.run().backward()
    return fwdbwd


def host_ms(fn: Callable[[], object], device: torch.device, reps: int
            ) -> float:
    """Median host ms of `reps` calls after WARM_CALLS, each call ending
    in a device synchronisation."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(WARM_CALLS):
        fn()
        sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def device_ms(fn: Callable[[], object], device: torch.device) -> float:
    """The device time of one call of `fn` under torch.profiler: every
    device event's duration, summed (the ranges the profiler mirrors from
    the host onto the device's timeline excluded)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    events = list(prof.events())
    on_device = torch.autograd.DeviceType.CUDA
    host_names = {e.name for e in events if e.device_type != on_device}
    total = sum(e.time_range.end - e.time_range.start for e in events
                if e.device_type == on_device and e.name not in host_names)
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total / 1e3


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    tiny = os.environ.get("BENCH_TINY", "0") == "1"
    batch_size = int(os.environ.get("BENCH_BATCH", "8" if tiny else "24"))
    reps = int(os.environ.get("BENCH_REPS", "10"))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    cfg, roberta, npoints, batch = bench_setup(tiny, batch_size)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, steps_per_epoch=1000, roberta_config=roberta,
                      backbone_npoints=npoints, device=device, seed=0)
    model = trainer.model
    print(f"# init {time.perf_counter() - t0:.0f}s", flush=True)

    results: Dict[str, float] = {}
    device_results: Dict[str, Optional[float]] = {}

    def measure(name, fn):
        results[name] = host_ms(fn, device, reps)
        device_results[name] = device_ms(fn, device) if cuda else None

    xyz = torch.from_numpy(batch["point_clouds"][..., :3].copy()).to(device)
    measure("canary_fps_tier1", lambda: furthest_point_sample(xyz,
                                                              npoints[0]))
    measure("full_step", lambda: trainer.train_step(batch))

    on_device = trainer.to_device(batch)
    model.train()

    def loss_value():
        return trainer.loss(trainer.forward(on_device))[0]

    def loss_grad():
        trainer.optimizer.zero_grad(set_to_none=True)
        loss_value().backward()

    measure("fwd_loss_value", forward_only(loss_value))
    measure("fwd_loss_grad", loss_grad)
    measure("adamw_update", trainer.apply_gradients)

    stages = build_stages(model, cfg, batch, npoints, device)
    for name in ("backbone", "text", *STAGES[1:]):
        measure(f"{name}_fwd", forward_only(stages[name].run))
        if name != "text":
            measure(f"{name}_fwdbwd", forward_backward(stages[name]))

    derived = {"bwd_total": ("fwd_loss_grad", "fwd_loss_value")}
    derived.update({f"{s}_bwd": (f"{s}_fwdbwd", f"{s}_fwd") for s in STAGES})
    for name, (whole, part) in derived.items():
        results[name] = results[whole] - results[part]
        device_results[name] = (device_results[whole] - device_results[part]
                                if cuda else None)

    out = {k: round(v, 3) for k, v in results.items()}
    out.update({f"{k}_device_ms": None if v is None else round(v, 3)
                for k, v in device_results.items()})
    out["peak_gib"] = (round(torch.cuda.max_memory_allocated(device)
                             / 2 ** 30, 3) if cuda else None)
    out["device"] = card_line() if cuda else "cpu"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
