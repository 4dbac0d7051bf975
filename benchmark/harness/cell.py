"""One run of one cell: set-up, warm-up, the measured window, in a traced
run two segments after it (one under the device's own trace, one that
records the host too), and the check of what the window's entry
produced.

Training cells drive `Trainer.train_step_on_device` (what the port's
`Trainer.train_step` runs before it reads its metrics back, and what the
port's harness calls each step): the next batch is handed over as soon as
the call returns, so the host may dispatch ahead. Evaluation cells drive
`Trainer.eval_step` and then the setup's grounding evaluator, as the
port's harness evaluates an epoch (with the loss, its values read back
once a batch, unless the setup is butd_cls). Both are closed loops of one
stream over a pool of distinct host batches made in set-up.
"""

import gc
import random
import time
from typing import Dict, List, Optional

import torch

from benchmark.harness import check, flops, program, spec
from benchmark.harness import roofline as rl
from benchmark.harness import trace as tr
from benchmark.harness.weights import make_weights
from benchmark.traffic.generator import make_pool

CHECK_STEPS = 3


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _no_beat() -> None:
    pass


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return x


class Run:
    """What the metric readers read: the cell, its mode, the host-clock
    spans of the window, the reduction of the traced segments (the device's
    own trace, with the idle gaps of the host's), the FLOP count and the
    roofline bounds."""

    def __init__(self, cell: Dict, mode: str, fault: Optional[str] = None):
        self.cell = cell
        self.mode = mode  # "train" or "eval"
        self.fault = fault
        self.spans: Dict[str, List[float]] = {"step": [], "evaluate": [],
                                              "batch": []}
        self.chips = 1  # the devices whose work the window's scenes are
        self.window_s = 0.0
        self.setup_s = 0.0
        self.scenes = 0
        self.steps = 0
        self.flops_per_scene = 0.0
        self.trace: Optional[Dict] = None
        self.trace_steps = 0
        self.setup_parts: Dict[str, float] = {}
        self.bounds: Dict[str, float] = {}
        self.patterns: Dict[str, List[str]] = {}


def run_cell(cell: Dict, seed: int, seconds: float, traced: bool,
             device="cuda", control: bool = False,
             fault: Optional[str] = None,
             t_start: Optional[float] = None) -> Dict:
    """Run `cell` (`spec.load_cell`) once; returns the result line's
    fields and the Run."""
    t_start = time.perf_counter() if t_start is None else t_start
    entry, config = cell["entry"], cell["config"]
    mode = entry["entry"]
    if mode not in ("train", "eval"):
        raise ValueError(f"unknown entry {mode!r}")
    run = Run(cell, mode, fault)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    run.setup_parts["imports"] = time.perf_counter() - t_start
    trainer, recorder, pool = set_up(run, seed, seed, device, control,
                                     t_start)
    if mode == "train":
        return _train(run, trainer, recorder, pool, seconds, traced, device,
                      t_start, config, seed)
    return _eval(run, trainer, recorder, pool, seconds, traced, device,
                 t_start, config, seed)


def set_up(run: Run, seed: int, pool_seed: int, device, control: bool,
           t_start: float, mesh=None):
    """(trainer, recorder, pool): the pool of host batches from
    `pool_seed`, the weights from `seed`, the trainer (this rank's, with a
    `mesh`) with the run's fault planted; each part's seconds into
    `run.setup_parts`."""
    entry, config = run.cell["entry"], run.cell["config"]
    parts = run.setup_parts
    pool = make_pool(run.cell["traffic"], config["data"], entry["batch"],
                     entry["pool_batches"], pool_seed, device)
    _sync(device)
    parts["pool"] = time.perf_counter() - t_start - sum(parts.values())
    weights = make_weights(config, seed, device)
    _sync(device)
    parts["weights"] = time.perf_counter() - t_start - sum(parts.values())
    trainer_seed = seed % (2 ** 62)
    trainer = program.build_trainer(config, weights, trainer_seed, device,
                                    control=control, mesh=mesh)
    del weights
    parts["trainer"] = time.perf_counter() - t_start - sum(parts.values())
    program.plant(trainer, run.fault)
    return trainer, program.Recorder(trainer), pool


# ------------------------------------------------------------- training

def checked_steps(trainer, recorder, pool, config) -> Dict:
    """The first CHECK_STEPS steps through the window's own entry, with
    what the check compares recorded: each step's loss, the first
    gradient as AdamW got it (from its first moment), the parameters
    after the steps, and the program's decisions on its way."""
    losses, first_grad = [], None
    names = {p: n for n, p in trainer.model.named_parameters()
             if p.requires_grad}
    recorder.armed = True
    for i in range(CHECK_STEPS):
        metrics = trainer.train_step_on_device(program.train_feed(pool[i]))
        losses.append(program.metrics_to_host(metrics)["loss"])
        if i == 0:
            b1 = config["optimizer"]["betas"][0]
            first_grad = {}
            for p, n in names.items():
                st = trainer.optimizer.state.get(p, {})
                m = st.get("exp_avg", torch.zeros_like(p))
                first_grad[n] = (m / (1.0 - b1)).cpu()
    recorder.armed = False
    after = {n: p.detach().cpu().clone() for p, n in names.items()}
    recorded = {"losses": losses, "first_grad": first_grad, "after": after,
                "forward": [{k: _cpu(v) for k, v in f.items()}
                            for f in recorder.forward],
                "matches": [_cpu(m) for m in recorder.matches]}
    recorder.close()
    return recorded


def _train(run, trainer, recorder, pool, seconds, traced, device, t_start,
           config, seed, world=None):
    """The checked steps, the warm-up, the window, in a traced run the
    segments after it, and the check. On one chip the window steps until
    `seconds` have passed. With `world` (`ranks.World`: this rank of a
    run on several GPUs) every rank takes the number of steps that rank 0
    fixes from the warm-up's pace, beats the watchdog as it goes, closes
    the window at a barrier and runs the traced segments; the window's
    scenes are every rank's, and the check runs over the ranks, with
    `replica_gap` besides."""
    entry = run.cell["entry"]
    B = entry["batch"]
    beat = world.beat if world else _no_beat
    recorded = checked_steps(trainer, recorder, pool, config)
    gap = world.replica_gap(trainer.model) if world else None
    parts = run.setup_parts
    parts["checked_steps"] = time.perf_counter() - t_start \
        - sum(parts.values())
    beat()
    # warm-up beyond the checked steps: the window's shapes are all built
    t = time.perf_counter()
    for i in range(entry["warmup"]):
        trainer.train_step_on_device(
            program.train_feed(pool[(CHECK_STEPS + i) % len(pool)]))
        beat()
    _sync(device)
    if world:
        done = world.window_done(
            seconds, (time.perf_counter() - t) / max(1, entry["warmup"]))
    else:
        def done(steps, elapsed):
            return elapsed >= seconds
    parts["warmup"] = time.perf_counter() - t_start - sum(parts.values())
    steps, at = 0, CHECK_STEPS + entry["warmup"]
    step_spans = run.spans["step"]
    before = program.launches()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while not done(steps, time.perf_counter() - t0):
        batch = program.train_feed(pool[at % len(pool)])
        at += 1
        s = time.perf_counter()
        trainer.train_step_on_device(batch)
        step_spans.append(time.perf_counter() - s)
        steps += 1
        beat()
    _sync(device)
    if world:
        world.barrier()
    run.window_s = time.perf_counter() - t0
    run.steps, run.scenes = steps, steps * B * run.chips
    per_step = {k: v / steps for k, v in
                program.launches_since(before).items() if v}
    if traced:
        def segment(n):
            def go():
                for j in range(n):
                    with torch.profiler.record_function("bench.train_step"):
                        trainer.train_step_on_device(
                            program.train_feed(pool[(at + j) % len(pool)]))
                    beat()
            return go

        _traced(run, segment)
    peak = _peak(device)
    # the program's state goes before the reference runs (the closure
    # above holds the name's cell, which `del` empties)
    del trainer
    _free(device)
    numbers = check.train_numbers(
        config, make_weights(config, seed, device), pool[:CHECK_STEPS],
        check.seeds_of(seed % (2 ** 62), CHECK_STEPS,
                       world.rank if world else 0),
        recorded, device, group=world.group if world else None)
    if world:
        numbers["replica_gap"] = gap
        beat()
    return _finish(run, numbers, steps, setup_s, peak, per_step, config,
                   pool)


# ----------------------------------------------------------- evaluation

def _eval(run, trainer, recorder, pool, seconds, traced, device, t_start,
          config, seed):
    entry = run.cell["entry"]
    B = entry["batch"]
    wl = program.with_loss(config)
    evaluator = program.build_evaluator(config)
    program.plant_evaluator(evaluator, run.fault)

    def one(batch):
        ep = trainer.eval_step(program.eval_feed(batch), with_loss=wl)
        if wl:
            program.metrics_to_host({k: ep[k] for k in (
                "loss", "loss_ce", "loss_bbox", "loss_giou",
                "loss_contrastive_align", "query_points_generation_loss")
                if k in ep})
        return ep

    def evaluate(ep, batch):
        for k in program.EVALUATOR_KEYS:
            ep.setdefault(k, batch[k])
        evaluator.evaluate(ep)

    for i in range(entry["warmup"]):
        evaluate(one(pool[i % len(pool)]), pool[i % len(pool)])
    evaluator.reset()
    _sync(device)
    parts = run.setup_parts
    parts["warmup"] = time.perf_counter() - t_start - sum(parts.values())
    picks = sorted(random.Random(seed).sample(range(entry["judged_within"]),
                                              entry["judged_batches"]))
    samples = []
    _sync(device)
    n, at = 0, entry["warmup"]
    step_s, eval_s, batch_s = run.spans["step"], run.spans["evaluate"], \
        run.spans["batch"]
    before = program.launches()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while time.perf_counter() - t0 < seconds or n <= picks[-1]:
        batch = pool[at % len(pool)]
        judged = n in picks
        recorder.armed = judged
        s = time.perf_counter()
        ep = one(batch)
        m = time.perf_counter()
        if judged:
            counts0 = dict(evaluator.dets)
        evaluate(ep, batch)
        e = time.perf_counter()
        if judged:
            samples.append({"batch": batch, "ep": ep, "counts": {
                k: evaluator.dets[k] - counts0[k] for k in evaluator.dets},
                "match": recorder.matches[-1] if wl else None})
        step_s.append(m - s)
        eval_s.append(e - m)
        batch_s.append(e - s)
        n += 1
        at += 1
    recorder.armed = False
    _sync(device)
    run.window_s = time.perf_counter() - t0
    run.steps, run.scenes = n, n * B
    per_step = {k: v / n for k, v in program.launches_since(before).items()
                if v}
    if traced:
        def segment(n):
            def go():
                for j in range(n):
                    batch = pool[(at + j) % len(pool)]
                    with torch.profiler.record_function("bench.eval_step"):
                        ep = one(batch)
                    with torch.profiler.record_function("bench.evaluate"):
                        evaluate(ep, batch)
            return go

        _traced(run, segment)
    peak = _peak(device)
    recorder.close()
    for s in samples:
        s["ep"] = {k: _cpu(v) for k, v in s["ep"].items()}
        s["match"] = _cpu(s["match"])
    # the program's state goes before the reference runs (the closures
    # above hold the names' cells, which `del` empties)
    del trainer, evaluator
    _free(device)
    numbers = check.eval_numbers(config, make_weights(config, seed, device),
                                 samples, wl, device)
    return _finish(run, numbers, n, setup_s, peak, per_step, config, pool)


# ---------------------------------------------------------------- common

def _traced(run, segment) -> None:
    """After the window: `device_trace_steps` steps under the device's own
    trace, for the readers and the `device` fields, then `trace_steps`
    under the trace of host and device, whose idle gaps go into the
    breakdown. (`segment(n)` gives the call that runs n steps.)"""
    entry = run.cell["entry"]
    with tr.device_window() as trace:
        segment(entry["device_trace_steps"])()
    run.trace = dict(trace, idle_gaps=tr.idle_gaps(tr.record(
        segment(entry["trace_steps"]))))
    run.trace_steps = entry["device_trace_steps"]


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def step_bounds(config: Dict, batch: int, valid: float, training: bool
                ) -> Dict[str, float]:
    """{kernel function: least seconds of one step's or batch's calls} at
    the cell's widths, batch and mean valid targets a row."""
    names = spec.shape_names(config, batch, valid)
    modes = ["train"] if training else (
        ["eval", "eval_loss"] if program.with_loss(config) else ["eval"])
    return rl.cell_bounds(spec.rooflines(), modes, names)


def _finish(run, numbers, attempted, setup_s, peak, per_step, config,
            pool):
    entry = run.cell["entry"]
    training = run.mode == "train"
    run.flops_per_scene = flops.scene_flops(config, training)
    # the matcher's valid rows: the pool's mean targets a row
    valid = float(sum(float(b["box_label_mask"].sum()) for b in pool)) / (
        len(pool) * entry["batch"])
    run.bounds = step_bounds(config, entry["batch"], valid, training)
    fns = spec.rooflines()
    run.patterns = {fn: fns[fn]["patterns"] for fn in run.bounds}
    run.setup_s = setup_s
    checks = check.judge(numbers, entry["checks"])
    return {"run": run, "attempted": attempted, "peak": peak,
            "launches_per_step": per_step, "numbers": numbers,
            "checks": checks, "correct": check.passed(checks)}
