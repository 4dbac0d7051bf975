"""A training cell on several GPUs: one process a GPU, joined over NCCL,
under a watchdog.

`run_cell_ranks` is the entry of a cell whose `chips` is more than 1, as
`cell.run_cell` is of a one-chip cell. It starts one worker a device with
the `spawn` method (rank r on `cuda:r`; on the CPU, for the tests, every
rank on the host over gloo). The workers join the port's process group
(`program.join_ranks`, `tcp://127.0.0.1:<free port>`), every rank on one
dp axis; rank 0 builds and loads the port's kernels and host runtime while
the others wait at a barrier, and then they load what it built. Each, with
one intra-op thread, builds the port's `Trainer` on that axis: the cell's
batch on each rank, the world's batch as the port's `--batch_size`. A
rank's pool of batches is drawn from the seed with the rank mixed in, as
a `DistributedSampler` gives each process its own rows of the mix; the
weights are the seed's on every rank.

Every rank runs one-chip training's own sequence (`cell._train`, driven
through a `World`): the checked steps, the warm-up and then the same
number of steps in the window: rank 0 fixes that number from the
warm-up's pace and broadcasts it once, before the window, which then
holds no collective but the program's own and closes with every device
drained and a barrier. In a traced run every rank runs the traced
segments under the profiler, so that each pays its cost alike. Rank 0's
window is the run's (its seconds, its host spans, its device trace); the
window's scenes are every rank's. Each rank compares its own rows with
the reference in its distributed mode, and the widest reading over the
ranks is judged.

The watchdog: each worker beats (writes the clock into a shared array) at
every step and after each part of its set-up, and every few seconds while
rank 0 builds the kernels (for at most `BUILD_S`). A worker that raises or
exits ends the run at once; so does a world in which no rank has beaten
for `stall_s` seconds (a collective waiting for a rank that never joins
it). Either way every worker is killed and waited for, and `RanksFailed`
raised. A worker dies with this process (`PR_SET_PDEATHSIG`), so none
outlives a parent that is killed. `time.perf_counter` reads the system's
monotonic clock on Linux, so the set-up is timed from the parent's start
to rank 0's window.
"""

import ctypes
import math
import multiprocessing as mp
import os
import signal
import socket
import tempfile
import threading
import time
from typing import Dict, List

import torch
import torch.distributed as dist

from benchmark.harness import cell as cells
from benchmark.harness import check, program, report

STALL_S = 120.0  # no rank beat for this long: the world is stalled
BUILD_S = 900.0  # rank 0 beats while it builds the kernels, this long at most
EXIT_GRACE_S = 30.0  # after every result is in, for the ranks' teardown
POLL_S = 0.2
# a worker's intra-op threads: one, as torchrun gives each process of a
# launch on several GPUs (OMP_NUM_THREADS=1); four workers of a one-chip
# cell's four threads each left the host's pace, and the rate, less steady
THREADS = 1
POOL_STRIDE = 1_000_000_007  # a rank's pool seed: seed + rank * stride


class RanksFailed(RuntimeError):
    """A worker raised, exited, stalled or disagreed with the others; every
    worker has been ended."""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _result_path(out: str, rank: int) -> str:
    return os.path.join(out, f"rank{rank}.pt")


def run_cell_ranks(cell: Dict, seed: int, seconds: float, traced: bool,
                   device="cuda", control: bool = False, fault=None,
                   t_start=None, stall_s: float = STALL_S,
                   worker=None) -> Dict:
    """Run the training cell `cell` once on `cell["bench"]["chips"]`
    ranks; returns the result line's fields as `cell.run_cell` does, with
    rank 0's Run, and `device`, `forbidden` and `steps_by_rank` besides.
    `worker` stands in for `work` (a test's, importable by name)."""
    t_start = time.perf_counter() if t_start is None else t_start
    if cell["entry"]["entry"] != "train":
        raise ValueError("a cell on several GPUs trains")
    world = cell["bench"]["chips"]
    ctx = mp.get_context("spawn")
    beats = ctx.Array("d", world, lock=False)
    with tempfile.TemporaryDirectory() as out:
        args = (world, _free_port(), out, beats, cell, seed, seconds, traced,
                device, control, fault, t_start)
        procs = [ctx.Process(target=worker or work, args=(r, *args),
                             name=f"rank{r}") for r in range(world)]
        now = time.monotonic()
        for r in range(world):
            beats[r] = now
        try:
            for p in procs:
                p.start()
            _watch(procs, beats, out, stall_s)
        finally:
            _end(procs)
        results = [torch.load(_result_path(out, r), map_location="cpu",
                              weights_only=False) for r in range(world)]
    return merge(cell, results)


def _watch(procs, beats, out: str, stall_s: float) -> None:
    """Return once every worker has handed in its result and exited (or,
    after EXIT_GRACE_S, is still tearing down); raise RanksFailed when one
    exits with another code than 0 or the world stalls."""
    handed_in = None
    while True:
        codes = [p.exitcode for p in procs]
        for r, c in enumerate(codes):
            if c not in (None, 0):
                raise RanksFailed(f"rank {r} exited with code {c}")
        if all(c == 0 for c in codes):
            return
        now = time.monotonic()
        if all(os.path.exists(_result_path(out, r))
               for r in range(len(procs))):
            handed_in = handed_in or now
            if now - handed_in > EXIT_GRACE_S:
                report.log(f"ranks still in teardown {EXIT_GRACE_S:.0f} s "
                           f"after their results: ended")
                return
        elif now - max(beats) > stall_s:
            idle = ", ".join(f"rank {r} {now - b:.0f} s"
                             for r, b in enumerate(beats))
            raise RanksFailed(f"no rank made progress in {stall_s:.0f} s "
                              f"(since each one's last: {idle})")
        time.sleep(POLL_S)


def _end(procs) -> None:
    for p in procs:
        if p.pid is not None and p.is_alive():
            p.kill()
    for p in procs:
        if p.pid is not None:
            p.join(timeout=30)


def _widest(values: List):
    """The widest of the ranks' readings of one number (NaN if any is);
    a number that is not a plain number stays as the list of them."""
    if not all(isinstance(v, (int, float)) for v in values):
        return values
    if any(isinstance(v, float) and math.isnan(v) for v in values):
        return math.nan
    return max(values)


def merge(cell: Dict, results: List[Dict]) -> Dict:
    """The run's result from its ranks' (in rank order): rank 0's Run and
    window, each compared number's widest reading over the ranks judged
    against the cell's limits, the fullest device's peak."""
    steps = [r["steps"] for r in results]
    if len(set(steps)) != 1:
        raise RanksFailed(f"the ranks took {steps} steps in the window")
    first = results[0]["res"]
    numbers = {k: _widest([r["res"]["numbers"][k] for r in results])
               for k in first["numbers"]}
    checks = check.judge(numbers, cell["entry"]["checks"])
    return dict(first, numbers=numbers, checks=checks,
                correct=check.passed(checks),
                peak=max(r["res"]["peak"] for r in results),
                device=dict(results[0]["device"], count=len(results)),
                forbidden=sorted({m for r in results for m in r["forbidden"]}),
                steps_by_rank=steps)


# ------------------------------------------------------------ the worker

def _die_with_parent() -> None:
    """Have the kernel kill this process when the process that started it
    ends (Linux's `prctl(PR_SET_PDEATHSIG, SIGKILL)`)."""
    try:
        ctypes.CDLL(None).prctl(1, int(signal.SIGKILL))
    except (OSError, AttributeError):
        pass


def _beating(beat, fn, limit_s: float) -> None:
    """Run `fn`, beating every few seconds meanwhile (for `limit_s` at
    most): a build in progress is progress."""
    done = threading.Event()

    def loop():
        t = time.monotonic()
        while not done.wait(5.0) and time.monotonic() - t < limit_s:
            beat()

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    try:
        fn()
    finally:
        done.set()
        th.join()


def work(rank: int, world: int, port: int, out: str, beats, cell: Dict,
         seed: int, seconds: float, traced: bool, device, control: bool,
         fault, t_start: float) -> None:
    """One rank of the run: its result goes to `out` (`torch.save`)."""
    def beat():
        beats[rank] = time.monotonic()

    _die_with_parent()
    torch.set_num_threads(THREADS)
    cuda = device == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device(device)
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    run = cells.Run(cell, "train", fault)
    run.chips = world
    parts = run.setup_parts
    parts["imports"] = time.perf_counter() - t_start
    mesh = program.join_ranks("nccl" if cuda else "gloo", rank, world,
                              f"tcp://127.0.0.1:{port}")
    beat()
    # one build of the kernels: rank 0's, which the others then load
    if cuda and rank == 0:
        _beating(beat, program.load_kernels, BUILD_S)
    dist.barrier()
    if cuda and rank > 0:
        program.load_kernels()
    parts["kernels"] = time.perf_counter() - t_start - sum(parts.values())
    beat()
    trainer, recorder, pool = cells.set_up(
        run, seed, (seed + rank * POOL_STRIDE) % 2 ** 63, dev, control,
        t_start, mesh)
    beat()
    res = cells._train(run, trainer, recorder, pool, seconds, traced, dev,
                       t_start, cell["config"], seed, World(rank, beat, dev))
    result = {"res": res, "steps": res["attempted"],
              "device": report.card(dev),
              "forbidden": report.forbidden_modules()}
    path = _result_path(out, rank)
    torch.save(result, path + ".tmp")
    os.replace(path + ".tmp", path)
    beat()
    dist.barrier()
    dist.destroy_process_group()


class World:
    """This rank of a run on several GPUs, as `cell._train` drives it: the
    watchdog's beat, the window's step count, its closing barrier, the
    process group the check's reference reduces over, `replica_gap`."""

    def __init__(self, rank: int, beat, device):
        self.rank = rank
        self.beat = beat
        self.device = device
        self.group = dist.group.WORLD

    def window_done(self, seconds: float, pace: float):
        """The window's test of whether it is done after `steps`: the
        steps that fill `seconds` at rank 0's warm-up `pace`, one number
        for every rank (one broadcast, before the window)."""
        t = torch.tensor([max(1, round(seconds / pace))], dtype=torch.int64,
                         device=self.device)
        dist.broadcast(t, src=0)
        n = int(t.item())

        def done(steps: int, elapsed: float) -> bool:
            return steps >= n
        return done

    def barrier(self) -> None:
        dist.barrier()

    def replica_gap(self, model: torch.nn.Module) -> float:
        return replica_gap(model, self.device)


@torch.no_grad()
def replica_gap(model: torch.nn.Module, device) -> float:
    """The largest absolute difference between this rank's and rank 0's
    model state: every parameter and buffer (BatchNorm's running
    statistics and counts among them), one broadcast a dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in model.state_dict().values():
        if t.numel():
            by_dtype.setdefault(t.dtype, []).append(t.reshape(-1))
    gap = torch.zeros((), dtype=torch.float64, device=device)
    for tensors in by_dtype.values():
        mine = torch.cat(tensors)
        first = mine.clone()
        dist.broadcast(first, src=0)
        d = (mine - first).abs().max() if mine.is_floating_point() else \
            (mine.double() - first.double()).abs().max()
        gap = torch.maximum(gap, d.double())  # NaN stays NaN
    return float(gap)


__all__ = ["RanksFailed", "World", "merge", "replica_gap", "run_cell_ranks",
           "work"]
